"""The whole slice on the CPU: ``weakly --alternating --smoke --device cpu``
runs end to end through the CLI, and the pipeline refuses what is not
ported yet."""

import dataclasses
import json
import math

import pytest
from test_torch_refine import single_torch_thread  # noqa: F401  (fixture)

from weaklysuperviseddl_tpu_torch.cli import main
from weaklysuperviseddl_tpu_torch.config import MaskConfig, MeshConfig, SegConfig, smoke_config
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


@pytest.mark.parametrize("change,match", [
    (dict(mesh=MeshConfig(data=2)), "one device"),
    (dict(mesh=MeshConfig(model=2)), "one device"),
    (dict(seg=SegConfig(loss_fn="lovasz_softmax")), "Lovász"),
    (dict(mask=MaskConfig(use_crf=True)), "K3"),
])
def test_pipeline_refuses_what_is_not_ported(change, match):
    cfg = dataclasses.replace(smoke_config(), **change)
    with pytest.raises((ValueError, NotImplementedError), match=match):
        run_weakly_supervised_alternating(cfg, device="cpu")


def test_pipeline_refuses_checkpoints():
    with pytest.raises(NotImplementedError, match="checkpoint"):
        run_weakly_supervised_alternating(smoke_config(), checkpoint_dir="x", device="cpu")
    with pytest.raises(NotImplementedError, match="checkpoint"):
        run_weakly_supervised_alternating(smoke_config(), resume=True, device="cpu")


def test_cli_rejects_stray_arguments(capsys):
    with pytest.raises(SystemExit):
        main(["weakly", "--smoke", "--device", "cpu", "stray"])
    with pytest.raises(SystemExit):
        main(["serve", "--smoke", "--device", "cpu", "--seg.epochs", "2"])
