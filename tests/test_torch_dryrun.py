"""The port's ``dryrun`` command and a ``weakly`` run on a mesh, through the
CLI on gloo ranks that the commands start themselves.

``dryrun --devices 4 --device cpu`` prints the JAX dryrun's stage lines, as
MULTICHIP_r05.json records them, in their order. ``weakly --alternating
--smoke --device cpu --mesh.data 2 --mesh.model 2`` equals the one-device
run: the seg loss (rtol 1e-5) and the final masks of the last snapshot.
The run takes ``--seg.batch_size 3``, which the data axis does not divide,
so it trains on the one-device run's batches (the batch left unsharded, as
JAX does) while every other part of the mesh run is exercised: rank 0's
stages and their broadcast, the tensor-parallel model, the guard's
mesh-wide decision, the lockstep eval, the sweeps and their broadcast, and
the gathered snapshot. A data-parallel run trains on other batches than a
one-device run by design (per-shard permutations, JAX's layout); its steps
and epoch are held against JAX's in test_torch_mesh.py."""

import json
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from test_torch_refine import single_torch_thread  # noqa: F401  (fixture)

from weaklysuperviseddl_tpu_torch.cli import main

ROOT = pathlib.Path(__file__).resolve().parents[1]
WEAKLY = ["weakly", "--alternating", "--smoke", "--device", "cpu", "--seg.batch_size", "3"]


def _cli(*args) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-m", "weaklysuperviseddl_tpu_torch", *args],
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish(proc: subprocess.Popen) -> str:
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-4000:]
    return out


@pytest.fixture(scope="module")
def commands(tmp_path_factory):
    """Both multi-rank commands start at once; the one-device run goes on in
    this process meanwhile."""
    ckpt = tmp_path_factory.mktemp("ckpt")
    dryrun = _cli("dryrun", "--devices", "4", "--device", "cpu")
    weakly = _cli(*WEAKLY, "--mesh.data", "2", "--mesh.model", "2",
                  "--checkpoint-dir", str(ckpt / "mesh"))
    yield {"dryrun": dryrun, "weakly": weakly, "ckpt": ckpt}
    for proc in (dryrun, weakly):  # a command no test waited for
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def test_dryrun_prints_jax_stage_lines_in_order(commands):
    want = json.loads((ROOT / "MULTICHIP_r05.json").read_text())["tail"].splitlines()
    # each number may differ (other weights and draws), the words may not
    patterns = [re.escape(re.sub(r"[0-9]+(?:\.[0-9]+)?", "NUM", line)).replace(
        "NUM", r"-?[0-9]+(?:\.[0-9]+)?") for line in want]
    got = [line for line in _finish(commands["dryrun"]).splitlines() if line.startswith("dryrun")]
    assert len(got) == len(want), got
    for line, pattern in zip(got, patterns):
        assert re.fullmatch(pattern, line), (line, pattern)
    # 4 ranks: JAX's rule gives a model axis of 2 from 4 devices up
    assert got[0].startswith("dryrun_multichip OK: mesh data=2 x model=2, batch 4, loss ")


def test_weakly_on_a_mesh_matches_one_device(commands, capsys, single_torch_thread):  # noqa: F811
    ckpt = commands["ckpt"]
    assert main([*WEAKLY, "--checkpoint-dir", str(ckpt / "one")]) == 0
    one = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    mesh = json.loads(_finish(commands["weakly"]).strip().splitlines()[-1])
    np.testing.assert_allclose(mesh["final_loss"], one["final_loss"], rtol=1e-5)
    with np.load(ckpt / "one" / "alt_000" / "masks.npz") as a, \
            np.load(ckpt / "mesh" / "alt_000" / "masks.npz") as b:
        assert a["keys"].tolist() == b["keys"].tolist()
        np.testing.assert_array_equal(a["masks"], b["masks"])
        np.testing.assert_array_equal(a["images"], b["images"])
    # rank 0 wrote the snapshot from whole (gathered) tensors: the one-device layout
    one_state = torch.load(ckpt / "one" / "alt_000" / "state.pt", weights_only=True)
    mesh_state = torch.load(ckpt / "mesh" / "alt_000" / "state.pt", weights_only=True)
    assert mesh_state["step"] == one_state["step"]
    assert {k: v.shape for k, v in mesh_state["model"].items()} == \
        {k: v.shape for k, v in one_state["model"].items()}
