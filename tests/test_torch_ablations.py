"""The ablation grid and the pieces it adds, against the JAX package:
refine_pseudo_masks (the model-facing refinement), masks_from_cams with an
order and a cap, run_key's independence from the process, one grid point by
the factored path (CAMs once, reordered) against the reference's shape
(masks and evaluation from loaders), the grid harness, and the CLI's
``ablations``."""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_models import jax_deeplab_numpy, port_from_jax
from test_torch_refine import single_torch_thread  # noqa: F401  (fixture)

from weaklysuperviseddl_tpu.masks.pseudo import ResidentCams as JaxResidentCams
from weaklysuperviseddl_tpu.masks.pseudo import masks_from_cams as jax_masks_from_cams
from weaklysuperviseddl_tpu.train.refine import refine_pseudo_masks as jax_refine_pseudo_masks
from weaklysuperviseddl_tpu_torch.cli import main
from weaklysuperviseddl_tpu_torch.config import smoke_config
from weaklysuperviseddl_tpu_torch.data.dataset import download_data, load_split_data
from weaklysuperviseddl_tpu_torch.data.loader import batches, stack_dataset
from weaklysuperviseddl_tpu_torch.masks.pseudo import ResidentCams, extract_cams, masks_from_cams
from weaklysuperviseddl_tpu_torch.pipelines.ablations import (
    default_grid,
    run_ablation,
    run_ablation_experiment,
    run_key,
)
from weaklysuperviseddl_tpu_torch.pipelines.weakly import build_classifier
from weaklysuperviseddl_tpu_torch.train.refine import refine_pseudo_masks

pytestmark = pytest.mark.usefixtures("single_torch_thread")


@pytest.mark.parametrize("loss", ["ncut", "boundary"])
def test_refine_pseudo_masks_matches_jax(loss):
    """S from each package's model on the same weights, then the refinement
    (XLA in the JAX package, the plain version on the CPU here): masks equal,
    loss rtol 1e-5; at lr 0.2 pixels move. The model's mode is restored."""
    model, variables = jax_deeplab_numpy(18, 0.25, seed=1)
    port = port_from_jax(variables, 18, 0.25).train()
    rng = np.random.default_rng(7)
    images = rng.standard_normal((2, 32, 40, 3)).astype(np.float32)
    masks = rng.integers(0, 2, (2, 32, 40)).astype(np.int32)
    kw = dict(lr=0.2, num_steps=5, loss=loss)
    want_m, want_l = jax_refine_pseudo_masks(model, variables["params"],
                                             variables["batch_stats"], jnp.asarray(images),
                                             jnp.asarray(masks), use_pallas=False, **kw)
    got_m, got_l = refine_pseudo_masks(port, torch.from_numpy(images), torch.from_numpy(masks),
                                       **kw)
    assert port.training
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    assert (got_m.numpy() != masks).mean() > 0.01
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-5)


def _cams(n=10, size=32, seed=0):
    """Smooth CAMs in [0,1] with two bumps each (keep-largest has work to do),
    raw images and store images."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    cams = []
    for _ in range(n):
        c = np.zeros((size, size))
        for _ in range(2):
            cy, cx, r = rng.uniform(0.2, 0.8), rng.uniform(0.2, 0.8), rng.uniform(0.08, 0.2)
            c = np.maximum(c, np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r)))
        cams.append(c + 0.05 * rng.random((size, size)))
    cams = np.clip(np.stack(cams), 0, 1).astype(np.float32)
    raw = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    store = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    return raw, cams, store


@pytest.mark.parametrize("order_seed,max_images,keep_largest", [
    (None, None, True), (1, 7, True), (2, 4, False), (3, 20, True)])
def test_masks_from_cams_order_and_cap_match_jax(order_seed, max_images, keep_largest):
    raw, cams, store_images = _cams()
    order = None
    if order_seed is not None:
        order = np.arange(len(cams))
        np.random.default_rng(order_seed).shuffle(order)
    want = jax_masks_from_cams(
        JaxResidentCams(jnp.asarray(raw), jnp.asarray(cams), jnp.asarray(store_images), 32, 4),
        cam_thresh=0.4, keep_largest_masks=keep_largest, order=order, max_images=max_images)
    got = masks_from_cams(
        ResidentCams(torch.from_numpy(raw), torch.from_numpy(cams),
                     torch.from_numpy(store_images), 32, 4),
        cam_thresh=0.4, keep_largest_masks=keep_largest, order=order, max_images=max_images)
    w_images, w_masks, w_keys = want.as_arrays()
    g_images, g_masks, g_keys = got.as_arrays()
    n = min(len(cams), max_images or len(cams))
    assert g_keys == w_keys and len(g_keys) == n
    np.testing.assert_array_equal(g_masks, w_masks)
    np.testing.assert_array_equal(g_images, w_images)
    taken = np.arange(len(cams)) if order is None else order
    np.testing.assert_array_equal(g_images, store_images[taken[:n]])


def test_run_key_is_the_same_in_every_process():
    """As the JAX package's test: two interpreters with different
    PYTHONHASHSEED give one key, which is also this process's."""
    code = ("from weaklysuperviseddl_tpu_torch.pipelines.ablations import run_key;"
            "print(run_key(42, 'abl_000_r0'))")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def launch(hashseed):
        env = {**os.environ, "PYTHONHASHSEED": str(hashseed)}
        out = subprocess.run([sys.executable, "-c", code], env=env, cwd=root, check=True,
                             capture_output=True, text=True, timeout=120)
        return int(out.stdout.strip().splitlines()[-1])

    assert launch(0) == launch(12345) == run_key(42, "abl_000_r0")
    assert len({run_key(s, f"abl_{c:03d}_r{r}") for s in (0, 1) for c in range(12)
                for r in range(3)}) == 72


def test_factored_grid_point_equals_the_reference_shape():
    """CAMs extracted once and reordered for the repeat give the result of
    extracting them from that repeat's shuffled loader and evaluating from the
    test loader: the same training (final loss equal) and metrics within
    1e-6 (the dataset evaluation sums per-image values in float32 on the
    device, the loader's in Python floats)."""
    cfg = smoke_config()
    d = cfg.data
    classifier = build_classifier(cfg, "cpu")
    train_ds, _ = load_split_data(d.root, train_ratio=d.train_ratio, seed=d.seed,
                                  synthetic_size=d.synthetic_size, image_size=d.image_size,
                                  num_classes=d.num_classes)
    test_ds = download_data(d.root, split="test", synthetic_size=16, image_size=d.image_size,
                            seed=d.seed, num_classes=d.num_classes)
    test_images, _, test_trimaps = stack_dataset(test_ds)
    repeat = 1
    order = np.arange(len(train_ds))
    np.random.default_rng(repeat).shuffle(order)
    resident = extract_cams(batches(train_ds, d.batch_size, pad_to_full=True), classifier,
                            image_size=d.image_size, max_images=None)
    common = dict(cam_method="LayerCAM", cam_thresh=0.3, alpha=1.0, lr=1e-3,
                  keep_largest=True, run_id="abl_000_r1", log=lambda s: None)
    factored = run_ablation(
        classifier, None, None, cfg=cfg, resident_cams=resident, mask_order=order,
        test_arrays=(torch.from_numpy(test_images), torch.from_numpy(test_trimaps)), **common)
    shaped = run_ablation(
        classifier, batches(train_ds, d.batch_size, shuffle=True, seed=repeat, pad_to_full=True),
        lambda: batches(test_ds, d.eval_batch_size, pad_to_full=True), cfg=cfg, **common)
    assert factored["final_loss"] == shaped["final_loss"]
    assert factored["run_id"] == shaped["run_id"]
    for key in ("iou", "acc"):
        assert factored[key] == pytest.approx(shaped[key], abs=1e-6)
    assert np.isfinite(factored["final_loss"]) and 0.0 <= factored["iou"] <= 1.0


def test_ablation_grid_pipeline():
    """As the JAX package's test: one combination × 2 repeats gives two runs
    and one summary under JAX's keys."""
    cfg = smoke_config()
    logs = []
    results = run_ablation_experiment([("LayerCAM", 0.3, 1.0, 1e-3, True)],
                                      build_classifier(cfg, "cpu"), cfg, num_repeats=2,
                                      log=logs.append)
    runs = [r for r in results if "run_id" in r]
    summaries = [r for r in results if "iou_mean" in r]
    assert [r["run_id"] for r in runs] == ["abl_000_r0", "abl_000_r1"]
    assert set(runs[0]) == {"run_id", "iou", "acc", "final_loss", "cam_method", "cam_thresh",
                            "alpha", "learning_rate", "keep_largest"}
    assert len(summaries) == 1 and set(summaries[0]) == {
        "combo_id", "cam_method", "cam_thresh", "alpha", "learning_rate", "keep_largest",
        "iou_mean", "iou_std", "acc_mean", "acc_std", "loss_mean", "loss_std"}
    assert summaries[0]["iou_std"] >= 0.0
    assert summaries[0]["iou_mean"] == pytest.approx(np.mean([r["iou"] for r in runs]))
    assert sum("Extracting CAMs once" in s for s in logs) == 1
    assert len(default_grid()) == 12 and default_grid()[0] == ("LayerCAM", 0.3, 1.0, 1e-2, True)


def test_ablations_smoke_cli(capsys):
    assert main(["ablations", "--smoke", "--device", "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["combo_id"] == 0 and summary["iou_std"] == 0.0
    assert 0.0 <= summary["iou_mean"] <= 1.0 and np.isfinite(summary["loss_mean"])
