"""``run.py`` on a host without the card: it exits with an error and prints
no result, and never falls back to the CPU."""

from __future__ import annotations

import os
import subprocess
import sys

import pytest
import torch

from benchmark import harness


def test_run_without_a_card_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    env = dict(os.environ, HOME=str(tmp_path), TMPDIR=str(tmp_path), BENCH_RUN="x")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "alternation.deeplabv3_r50_os8.ncut_b4", "--seed", str(2**31 + 7), "--seconds", "1",
         "--trace", "0"], cwd=harness.ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 2
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_run_needs_every_argument():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "x"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
