"""The rest of a run, the look for a card skipped, on the CPU at a tiny
size: sound runs come out correct, and with the timed path broken
underneath, correct comes out false, once for each fault the cell can have
(a step that returns its state unchanged, half of the batch left out of the
loss, an answer altered where it is produced; one chip, so no exchange
between chips), and for the graphed chunk of training steps, the sweep's
refinement and the hand-over from CAMs to masks, which the window drives
besides."""

from __future__ import annotations

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny

ALT = "alternation.deeplabv3_r50_os8.ncut_b4"
SERVE = "serve.deeplabv3_r50_os8.int8_b64"
CRF = "pseudo_masks.resnet50_cam.crf"
NOCRF = "pseudo_masks.resnet50_cam.nocrf"


@pytest.fixture(autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 4))
    yield
    torch.set_num_threads(threads)


def _numbers(result):
    return {k: v["value"] for k, v in result["compared"].items()}


@pytest.mark.parametrize("name", [ALT, SERVE, CRF, NOCRF])
def test_sound_run_is_correct(name):
    result, run = tiny.run(name)
    assert result["correct"], result["compared"]
    assert result["attempted"] == len(run.units) >= 1


def test_unchanged_state_is_caught(monkeypatch):
    from weaklysuperviseddl_tpu_torch.train.guard import GuardedAdam

    monkeypatch.setattr(GuardedAdam, "step", lambda self: torch.ones((), dtype=torch.bool))
    result, _ = tiny.run(ALT)
    assert not result["correct"]
    assert _numbers(result)["change_leaf_gap"] == pytest.approx(1.0)


@pytest.mark.parametrize("mode", ["half_batch", "chunk_repeat", "chunk_frozen"])
def test_training_fault_is_caught(mode):
    with harness.driver("alternation").plant(mode):
        result, _ = tiny.run(ALT)
    assert not result["correct"], result["compared"]


def test_wrong_refinement_loss_is_caught(monkeypatch):
    """The sweep's refinement with its boundary weight doubled: a bounded
    error in K1's loss, which moves no mask pixel at this learning rate."""
    from weaklysuperviseddl_tpu_torch.train import alternating

    def doubled(*args, **kwargs):
        kwargs["lambda_boundary"] = 2 * kwargs["lambda_boundary"]
        return real(*args, **kwargs)

    real = alternating.refine_from_soft_predictions
    monkeypatch.setattr(alternating, "refine_from_soft_predictions", doubled)
    result, _ = tiny.run(ALT)
    assert not result["correct"]
    assert result["compared"]["sweep_loss_rel_gap"]["value"] > 1e-2


def test_altered_written_back_mask_is_caught(monkeypatch):
    from weaklysuperviseddl_tpu_torch.train import alternating

    def altered(*args, **kwargs):
        refined, loss = real(*args, **kwargs)
        refined[:, 0, :] = 1 - refined[:, 0, :]
        return refined, loss

    real = alternating.refine_from_soft_predictions
    monkeypatch.setattr(alternating, "refine_from_soft_predictions", altered)
    result, _ = tiny.run(ALT)
    assert not result["correct"]
    assert _numbers(result)["sweep_mask_mismatch_px"] > 0


def test_altered_served_mask_is_caught(monkeypatch):
    from weaklysuperviseddl_tpu_torch.pipelines import serve

    def inverted(*args, **kwargs):
        return ~real(*args, **kwargs)       # every bit of the packed masks

    real = serve.predict_masks
    monkeypatch.setattr(serve, "predict_masks", inverted)
    result, _ = tiny.run(SERVE)
    assert not result["correct"]


@pytest.mark.parametrize("name", [CRF, NOCRF])
def test_altered_cam_is_caught(monkeypatch, name):
    from weaklysuperviseddl_tpu_torch.masks import pseudo

    def shifted(*args, **kwargs):
        cam, logits = real(*args, **kwargs)
        return (cam + 0.01).clamp(max=1.0), logits

    real = pseudo.layercam
    monkeypatch.setattr(pseudo, "layercam", shifted)
    result, _ = tiny.run(name)
    assert not result["correct"]
    assert _numbers(result)["cam_mean_gap"] > 1e-3


@pytest.mark.parametrize("name", [CRF, NOCRF])
def test_altered_stored_mask_is_caught(monkeypatch, name):
    from weaklysuperviseddl_tpu_torch.masks import pseudo

    def altered(*args, **kwargs):
        m = real(*args, **kwargs).clone()
        m[:, 0, :] = 1 - m[:, 0, :]
        return m

    real = pseudo._derive_batch
    monkeypatch.setattr(pseudo, "_derive_batch", altered)
    result, _ = tiny.run(name)
    assert not result["correct"]
    assert _numbers(result)["mask_mismatch_share"] > 0


@pytest.mark.parametrize("name", [CRF, NOCRF])
def test_cams_moved_across_the_threshold_are_caught(monkeypatch, name):
    """CAMs a little under the threshold raised just over it: too few pixels
    for the mean gap, but the masks differ from those of the reference's
    own CAMs."""
    from weaklysuperviseddl_tpu_torch.masks import pseudo

    thresh = harness.load_cell(name)["params"]["cam_thresh"]

    def raised(*args, **kwargs):
        cam, logits = real(*args, **kwargs)
        band = (cam >= thresh - 0.05) & (cam < thresh)
        return torch.where(band, cam + 0.05, cam), logits

    real = pseudo.layercam
    monkeypatch.setattr(pseudo, "layercam", raised)
    result, _ = tiny.run(name)
    assert not result["correct"]
    assert _numbers(result)["handoff_mismatch_share"] > 0
