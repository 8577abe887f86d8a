"""Checkpoints and resume in the port (utils/checkpoint.py): the optimizer's
state round trip, save_state/restore_state and their structure check, the
snapshots' atomicity and naming, the JAX package's resume errors, the resume
contract (a run stopped after one alternation and resumed equals the run that
never stopped, as the JAX package's
tests/test_pipelines.py::test_alternating_resume_matches_uninterrupted_run
holds its own), and the CLI's --checkpoint-dir/--resume and serve
--checkpoint."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from test_torch_refine import single_torch_thread  # noqa: F401  (fixture)

from weaklysuperviseddl_tpu.utils.checkpoint import latest_alternation as jax_latest_alternation
from weaklysuperviseddl_tpu_torch.cli import main
from weaklysuperviseddl_tpu_torch.config import smoke_config
from weaklysuperviseddl_tpu_torch.data.mask_store import MaskStore
from weaklysuperviseddl_tpu_torch.models.deeplabv3 import DeepLabV3
from weaklysuperviseddl_tpu_torch.ops.resize import resize_nearest
from weaklysuperviseddl_tpu_torch.pipelines.weakly import run_weakly_supervised_alternating
from weaklysuperviseddl_tpu_torch.train.alternating import upload_store_resident
from weaklysuperviseddl_tpu_torch.train.guard import GuardedAdam
from weaklysuperviseddl_tpu_torch.train.segmentation import SegTrainState, create_seg_state
from weaklysuperviseddl_tpu_torch.utils.checkpoint import (
    latest_alternation,
    restore_alternation,
    restore_state,
    save_alternation,
    save_state,
    seg_state_tree,
)

pytestmark = pytest.mark.usefixtures("single_torch_thread")


def _small_state(seed=0, width=0.25, num_classes=2):
    model = DeepLabV3(num_classes=num_classes, backbone_depth=18, width_multiplier=width)
    return create_seg_state(model, seed=seed, lr=1e-3, device="cpu")


def _store(n=5, size=16, seed=0):
    rng = np.random.default_rng(seed)
    store = MaskStore()
    for i in range(n):
        store.put(f"{i:05d}", rng.integers(0, 256, (size, size, 3), dtype=np.uint8),
                  rng.integers(0, 2, (size, size)))
    return store


def _step(params, opt, x, scale=1.0):
    opt.zero_grad()
    loss = sum(((p * x[: p.numel()].view_as(p)) ** 2).sum() for p in params) * scale
    loss.backward()
    return opt.step()


def test_guarded_adam_round_trip_takes_the_same_next_step(tmp_path):
    """Moments, the step count and both non-finite counters go through
    save_state/restore_state; the next step after the restore is bit-equal to
    the step the original optimizer takes."""
    gen = torch.Generator().manual_seed(0)
    params = [torch.randn(3, 4, generator=gen, requires_grad=True),
              torch.randn(5, generator=gen, requires_grad=True)]
    opt = GuardedAdam(params, lr=1e-2)
    xs = [torch.randn(16, generator=gen) for _ in range(4)]
    _step(params, opt, xs[0])
    assert not _step(params, opt, xs[1], scale=float("nan"))   # skipped, counted
    _step(params, opt, xs[2])
    assert (opt.count, opt.notfinite_count, opt.total_notfinite) == (2, 0, 1)
    _step(params, opt, xs[1], scale=float("inf"))
    save_state(str(tmp_path / "opt.pt"), opt.state_dict())

    twins = [p.detach().clone().requires_grad_(True) for p in params]
    restored = GuardedAdam(twins, lr=1e-2)
    restored.load_state_dict(restore_state(str(tmp_path / "opt.pt"), restored.state_dict()))
    assert (restored.count, restored.notfinite_count, restored.total_notfinite) == (2, 1, 2)
    _step(params, opt, xs[3])
    _step(twins, restored, xs[3])
    for a, b in zip(params + opt.m + opt.v, twins + restored.m + restored.v):
        assert torch.equal(a, b)
    assert restored.count == opt.count == 3 and restored.notfinite_count == 0


def test_optimizer_state_must_fit_the_parameters():
    opt = GuardedAdam([torch.zeros(3, requires_grad=True)])
    other = GuardedAdam([torch.zeros(4, requires_grad=True)])
    with pytest.raises(ValueError, match="does not fit"):
        opt.load_state_dict(other.state_dict())


def test_save_state_restores_every_bit(tmp_path):
    """The seg state tree (weights, BN statistics, Adam moments and counters,
    step) written and read back equal, through torch.load(weights_only=True)."""
    state = _small_state(seed=1)
    with torch.no_grad():
        for i, m in enumerate(state.optimizer.m):
            m.fill_(0.5 + i)
        state.model.backbone.bn1.running_var.mul_(3.0)
    state.optimizer.count, state.step = 7, 9
    path = str(tmp_path / "state.pt")
    save_state(path, seg_state_tree(state))
    tree = restore_state(path, seg_state_tree(_small_state(seed=2)))
    want = seg_state_tree(state)
    assert tree["step"] == 9 and tree["optimizer"]["count"] == 7
    assert tree["model"].keys() == want["model"].keys()
    for k, v in want["model"].items():
        assert torch.equal(tree["model"][k], v), k
    for name in ("m", "v"):
        assert all(torch.equal(a, b) for a, b in zip(tree["optimizer"][name],
                                                     want["optimizer"][name]))


@pytest.mark.parametrize("change", [dict(width=0.5), dict(num_classes=3)])
def test_restore_state_refuses_another_config(tmp_path, change):
    """As the JAX package's restore_state: a state saved under another model
    config raises ValueError instead of loading."""
    path = str(tmp_path / "state.pt")
    save_state(path, seg_state_tree(_small_state()))
    with pytest.raises(ValueError, match="another structure"):
        restore_state(path, seg_state_tree(_small_state(**change)))


def test_save_alternation_is_atomic_and_replaces(tmp_path):
    """A leftover alt_NNN.tmp is cleared; a re-save of the same iteration
    replaces the snapshot; the restored store equals the saved one."""
    root = tmp_path / "ck"
    leftover = root / "alt_000.tmp"
    leftover.mkdir(parents=True)
    (leftover / "junk").write_text("from a killed run")
    state, store = _small_state(), _store()
    assert latest_alternation(str(root)) is None
    save_alternation(str(root), 0, state, store)
    assert sorted(os.listdir(root)) == ["alt_000"]
    assert sorted(os.listdir(root / "alt_000")) == ["masks.npz", "state.pt"]

    store.update_mask("00002", np.ones((16, 16), np.uint8))
    state.step = 5
    save_alternation(str(root), 0, state, store)
    assert sorted(os.listdir(root)) == ["alt_000"]
    restored, got, nxt = restore_alternation(str(root), _small_state(seed=3))
    assert nxt == 1 and restored.step == 5
    images, masks, keys = store.as_arrays()
    g_images, g_masks, g_keys = got.as_arrays()
    assert g_keys == keys
    np.testing.assert_array_equal(g_images, images)
    np.testing.assert_array_equal(g_masks, masks)
    assert g_masks.dtype == np.uint8 and g_masks[2].all()


def test_latest_alternation_prefers_the_padded_name(tmp_path):
    """alt_7 beside alt_007 (and a snapshot without its masks, and a .tmp):
    the index is 7 and restore reads the zero-padded directory, as the JAX
    package's _alternation_dirs does."""
    state = _small_state()
    save_alternation(str(tmp_path), 7, state, _store(seed=1))
    save_alternation(str(tmp_path), 3, state, _store(seed=2))
    os.rename(tmp_path / "alt_003", tmp_path / "alt_7")
    (tmp_path / "alt_9").mkdir()
    save_state(str(tmp_path / "alt_9" / "state.pt"), seg_state_tree(state))  # no masks
    (tmp_path / "alt_011.tmp").mkdir()
    assert latest_alternation(str(tmp_path)) == 7
    _, store, nxt = restore_alternation(str(tmp_path), _small_state())
    assert nxt == 8
    np.testing.assert_array_equal(store.as_arrays()[1], _store(seed=1).as_arrays()[1])
    # the JAX package finds no snapshot of its own format here
    assert jax_latest_alternation(str(tmp_path)) is None


def test_resume_errors_as_jax(tmp_path):
    with pytest.raises(ValueError, match="checkpoint_dir"):
        run_weakly_supervised_alternating(smoke_config(), resume=True, device="cpu")
    with pytest.raises(FileNotFoundError, match="no restorable alternation snapshots"):
        run_weakly_supervised_alternating(smoke_config(), checkpoint_dir=str(tmp_path),
                                          resume=True, device="cpu")
    with pytest.raises(FileNotFoundError):
        restore_alternation(str(tmp_path), state=None)


def test_resumed_upload_keeps_the_synced_masks():
    """The store is synced at seg_size, so a resumed run's upload gives back
    its masks unchanged (the nearest resize at the same size is the
    identity), while masks of another size are resized."""
    store = _store(n=3, size=64)
    _, dev_masks, _ = upload_store_resident(store, seg_size=64)
    np.testing.assert_array_equal(dev_masks.numpy(), store.as_arrays()[1])
    m = torch.from_numpy(store.as_arrays()[1])
    assert torch.equal(resize_nearest(m, (64, 64), torch_legacy=False, axes=(1, 2)), m)
    _, resized, _ = upload_store_resident(store, seg_size=80)
    assert resized.shape == (3, 80, 80)


def _cfg(num_alternations):
    cfg = smoke_config()
    # pseudo-masks at 56², trained and refined at 64²: the first upload resizes
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, image_size=56),
        alternating=dataclasses.replace(cfg.alternating, num_alternations=num_alternations))


def test_alternating_resume_matches_uninterrupted_run(tmp_path):
    """Stopped after alternation 0 and resumed, the run equals the 2-alternation
    run exactly: masks, parameters, BN statistics, Adam moments, step and
    alt_iou. The restored state equals the one the snapshot was taken of."""
    full = run_weakly_supervised_alternating(_cfg(2), checkpoint_dir=str(tmp_path / "full"),
                                             log=lambda s: None, device="cpu")
    dir_b = str(tmp_path / "interrupted")
    first = run_weakly_supervised_alternating(_cfg(1), checkpoint_dir=dir_b,
                                              log=lambda s: None, device="cpu")
    assert latest_alternation(dir_b) == 0
    saved = {k: v.clone() for k, v in first.seg_state.model.state_dict().items()}
    restored, store, nxt = restore_alternation(dir_b, _small_state(seed=5))
    assert nxt == 1 and restored.step == first.seg_state.step
    assert all(torch.equal(restored.model.state_dict()[k], v) for k, v in saved.items())
    assert restored.optimizer.count == first.seg_state.optimizer.count
    np.testing.assert_array_equal(store.as_arrays()[1], first.mask_store.as_arrays()[1])

    logs = []
    resumed = run_weakly_supervised_alternating(_cfg(2), checkpoint_dir=dir_b, resume=True,
                                                log=logs.append, device="cpu")
    assert any("Resumed" in s and "alternation 1" in s for s in logs)
    assert latest_alternation(dir_b) == 1

    _, masks_full, keys_full = full.mask_store.as_arrays()
    _, masks_res, keys_res = resumed.mask_store.as_arrays()
    assert keys_full == keys_res and masks_full.shape[1:] == (64, 64)
    np.testing.assert_array_equal(masks_full, masks_res)
    sd_full, sd_res = full.seg_state.model.state_dict(), resumed.seg_state.model.state_dict()
    for k in sd_full:
        assert torch.equal(sd_full[k], sd_res[k]), k
    opt_full, opt_res = full.seg_state.optimizer, resumed.seg_state.optimizer
    assert opt_full.count == opt_res.count and full.seg_state.step == resumed.seg_state.step
    assert all(torch.equal(a, b) for a, b in zip(opt_full.m + opt_full.v, opt_res.m + opt_res.v))
    assert resumed.metrics["alt_iou"] == full.metrics["alt_iou"]
    assert resumed.metrics["trajectory"] == full.metrics["trajectory"][1:]


def test_cli_checkpoint_resume_and_serve_round_trip(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    assert main(["weakly", "--alternating", "--smoke", "--device", "cpu",
                 "--checkpoint-dir", ck]) == 0
    assert latest_alternation(ck) == 0
    capsys.readouterr()
    timings = tmp_path / "t.json"
    assert main(["weakly", "--resume", "--smoke", "--device", "cpu", "--checkpoint-dir", ck,
                 "--alternating.num_alternations", "2", "--timings-out", str(timings)]) == 0
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [t["alternation"] for t in metrics["trajectory"]] == [2]
    assert 0.0 <= metrics["alt_iou"] <= 1.0
    record = json.loads(timings.read_text())
    assert record["cmd"].endswith("weakly --resume")
    assert set(record["phases"]) == {"data", "seg_training", "eval", "refinement_sweeps",
                                     "store_sync", "checkpoint"}
    assert latest_alternation(ck) == 1

    state_file = os.path.join(ck, "alt_001", "state.pt")
    assert main(["serve", "--smoke", "--device", "cpu", "--checkpoint", state_file]) == 0
    assert "smoke round trip OK" in capsys.readouterr().out
    with pytest.raises(SystemExit):   # a depth-18 state into the served ResNet-50
        main(["serve", "--device", "cpu", "--checkpoint", state_file])
    assert "do not fit DeepLabV3" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        main(["weakly", "--smoke", "--device", "cpu", "--checkpoint-dir", ck])
