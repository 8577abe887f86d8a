"""The readers of the program's spans on the CPU at a tiny size, in a traced
run: each metric that exists on the CPU reads a finite number, and the
serving path's pin and upload, which the CPU has not, read None."""

from __future__ import annotations

import math

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny

SERVE = "serve.deeplabv3_r50_os8.int8_b64"
CRF = "pseudo_masks.resnet50_cam.crf"
NOCRF = "pseudo_masks.resnet50_cam.nocrf"
NEW = {SERVE: ["forward_launch_ms.serve"],
       CRF: ["drain_ms.pseudo_masks", "upload_ms.pseudo_masks", "readback_ms.pseudo_masks",
             "store_fill_ms.pseudo_masks"]}
NEW[NOCRF] = NEW[CRF]


@pytest.fixture(autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 4))
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", [SERVE, CRF, NOCRF])
def test_span_readers_in_a_traced_run(name):
    result, run = tiny.run(name, trace=True)
    assert result["correct"], result["compared"]
    for metric in NEW[name]:
        assert math.isfinite(result["metrics"][metric]["value"]), metric
    assert result["notes"]["spans"]
    if name == SERVE:
        for metric in ("pin_ms.serve", "upload_ms.serve"):
            assert metric not in result["metrics"]
            assert harness.reader(metric).read(run) is None
