"""The whole slice on the CPU: ``weakly --alternating --smoke --device cpu``
runs end to end through the CLI (with the cross-entropy loss, and with the
dense CRF and the Lovász loss, and with the CRF's lattice), and the pipeline
refuses a mesh larger than its devices."""

import dataclasses
import json
import math

import pytest
from test_torch_refine import single_torch_thread  # noqa: F401  (fixture)

from weaklysuperviseddl_tpu_torch.cli import main
from weaklysuperviseddl_tpu_torch.config import MaskConfig, MeshConfig, smoke_config
from weaklysuperviseddl_tpu_torch.pipelines.weakly import run_weakly_supervised_alternating

pytestmark = pytest.mark.usefixtures("single_torch_thread")


def test_weakly_alternating_smoke_cli_end_to_end(tmp_path, capsys):
    timings = tmp_path / "t.json"
    assert main(["weakly", "--alternating", "--smoke", "--device", "cpu",
                 "--timings-out", str(timings), "--alternating.refine.num_steps", "3"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    metrics = json.loads(last)
    assert set(metrics) == {"iou", "acc", "final_loss", "alt_iou", "alt_acc", "trajectory"}
    for key in ("iou", "acc", "final_loss", "alt_iou", "alt_acc"):
        assert math.isfinite(metrics[key]), key
    assert 0.0 <= metrics["alt_iou"] <= 1.0 and 0.0 <= metrics["alt_acc"] <= 1.0
    assert len(metrics["trajectory"]) == 1 and metrics["trajectory"][0]["alternation"] == 1
    record = json.loads(timings.read_text())
    assert record["config"]["alternating"]["refine"]["num_steps"] == 3
    assert record["device"] == "cpu" and record["metrics"] == metrics
    assert set(record["phases"]) == {"data", "classifier_fc_training", "pseudo_mask_generation",
                                     "seg_training", "eval", "refinement_sweeps", "store_sync"}
    assert record["phases"]["seg_training"]["calls"] == 2
    assert all(p["seconds"] >= 0 for p in record["phases"].values())


def test_weakly_alternating_smoke_cli_with_crf_and_lovasz(tmp_path, capsys):
    """The CRF pseudo-mask path and the Lovász loss, through the CLI's dotted
    overrides: the config record shows them, the metrics are finite and every
    phase ran."""
    timings = tmp_path / "t.json"
    assert main(["weakly", "--alternating", "--smoke", "--device", "cpu",
                 "--timings-out", str(timings), "--mask.use_crf", "true",
                 "--seg.loss_fn", "lovasz_softmax", "--alternating.refine.num_steps", "2"]) == 0
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for key in ("iou", "acc", "final_loss", "alt_iou", "alt_acc"):
        assert math.isfinite(metrics[key]), key
    record = json.loads(timings.read_text())
    assert record["config"]["mask"]["use_crf"] is True
    assert record["config"]["mask"]["crf_backend"] == "subsampled"
    assert record["config"]["seg"]["loss_fn"] == "lovasz_softmax"
    assert set(record["phases"]) == {"data", "classifier_fc_training", "pseudo_mask_generation",
                                     "seg_training", "eval", "refinement_sweeps", "store_sync"}


def test_weakly_alternating_smoke_cli_with_the_lattice_crf(tmp_path, capsys):
    """The cycle with the CRF's permutohedral lattice, set on the CLI, runs
    to its end on the CPU."""
    timings = tmp_path / "t.json"
    assert main(["weakly", "--alternating", "--smoke", "--device", "cpu",
                 "--timings-out", str(timings), "--mask.use_crf", "true",
                 "--mask.crf_backend", "lattice", "--alternating.refine.num_steps", "2"]) == 0
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for key in ("iou", "acc", "final_loss", "alt_iou", "alt_acc"):
        assert math.isfinite(metrics[key]), key
    record = json.loads(timings.read_text())
    assert record["config"]["mask"]["crf_backend"] == "lattice"
    assert record["phases"]["pseudo_mask_generation"]["calls"] == 1


def test_pipeline_rejects_an_unknown_crf_backend():
    cfg = dataclasses.replace(smoke_config(), mask=MaskConfig(use_crf=True, crf_backend="exact"))
    with pytest.raises(ValueError, match="crf_backend"):
        run_weakly_supervised_alternating(cfg, device="cpu")


def test_crf_kwargs_follow_the_config():
    """The pipeline passes the CRF the config's fields under densecrf's names,
    as the JAX pipeline does."""
    from weaklysuperviseddl_tpu_torch.pipelines.weakly import crf_kwargs

    assert crf_kwargs(smoke_config()) is None
    cfg = dataclasses.replace(smoke_config(), mask=MaskConfig(use_crf=True, crf_iters=3,
                                                              crf_backend="attention"))
    assert crf_kwargs(cfg) == dict(gauss_sxy=1.0, gauss_compat=2.0, bilat_sxy=50.0,
                                   bilat_srgb=5.0, bilat_compat=10.0, n_iters=3,
                                   bilat_backend="attention", key_stride=2)


@pytest.mark.parametrize("mesh,match", [
    (MeshConfig(data=2), "mesh 2x1 != 1 devices"),
    (MeshConfig(model=2), "1 devices not divisible by model=2"),
])
def test_pipeline_refuses_a_mesh_larger_than_its_devices(mesh, match):
    """Outside a process group the CPU is one device: a mesh of two raises
    JAX's shape error before any stage runs (it never runs on fewer)."""
    cfg = dataclasses.replace(smoke_config(), mesh=mesh)
    with pytest.raises(ValueError, match=match):
        run_weakly_supervised_alternating(cfg, device="cpu")


def test_cli_rejects_stray_arguments(capsys):
    with pytest.raises(SystemExit):
        main(["weakly", "--smoke", "--device", "cpu", "stray"])
    with pytest.raises(SystemExit):
        main(["serve", "--smoke", "--device", "cpu", "--seg.epochs", "2"])
