"""The whole weakly-supervised cycle against the JAX package, stage by stage.

Both packages run ``run_weakly_supervised_alternating`` on ``smoke_config()``
(one alternation, one sweep) from the same initial weights: the JAX package's
own ``model.init`` trees, carried into the port by ``models/jax_import.py``.
Spies on each package's ``extract_cams`` and ``run_alternating_training``
keep the CAMs and the store's pseudo-masks as the cycle makes them; the
stages are then held to the definition of done's tolerances:

  * the fc parameters after classifier training (atol 1e-5, as
    ``test_torch_classifier.py`` holds one training run);
  * the CAMs (atol 2e-3);
  * the store's pseudo-masks (more than 99 % of pixels: a CAM within float
    noise of the 0.3 threshold may binarise differently);
  * the masks after the alternation's training and sweep (more than 99 %);
  * the IoU after the first segmentation training and after the alternation
    (within 0.01 absolute).

Known differences neutralised here, as the stage tests do:
  * the ASPP dropout's random bits cannot be reproduced across the two
    frameworks, so dropout is the identity on both sides (flax's ``Dropout``
    monkeypatched, as in ``test_torch_segmentation.py``; the port's
    ``Dropout.forward`` replaced by the identity);
  * Lovász's ``abs'(0)`` and K2's round limit do not arise: the smoke config
    trains with cross-entropy, and the smoke masks converge in K2's rounds.
Both packages draw the same batch order from the same seed (the loaders'
``np.random.default_rng(seed)`` permutations), so no order is fed in.

The same cycle runs again with ``classifier.dtype = seg.dtype =
"bfloat16"`` in both packages (``cycles_bf16``): each package rounds its own
way in bfloat16, so the store's masks and the masks after the sweep are held
to 99 % of the pixels and the IoUs to 0.02.
"""

import dataclasses

import flax.linen
import jax
import numpy as np
import pytest
import torch

import weaklysuperviseddl_tpu.masks.pseudo as jax_pseudo
import weaklysuperviseddl_tpu.train.alternating as jax_alternating
import weaklysuperviseddl_tpu_torch.masks.pseudo as port_pseudo
import weaklysuperviseddl_tpu_torch.pipelines.weakly as port_weakly
from weaklysuperviseddl_tpu.config import smoke_config as jax_smoke_config
from weaklysuperviseddl_tpu.models.deeplabv3 import DeepLabV3 as JaxDeepLabV3
from weaklysuperviseddl_tpu.parallel.mesh import mesh_from_config
from weaklysuperviseddl_tpu.pipelines.weakly import build_classifier as jax_build_classifier
from weaklysuperviseddl_tpu.pipelines.weakly import (
    run_weakly_supervised_alternating as jax_run_alternating,
)
from weaklysuperviseddl_tpu.train.segmentation import create_seg_state as jax_create_seg_state
from weaklysuperviseddl_tpu_torch.config import smoke_config
from weaklysuperviseddl_tpu_torch.models.deeplabv3 import Dropout
from weaklysuperviseddl_tpu_torch.models.jax_import import (
    cam_classifier_state_dict_from_jax,
    deeplab_state_dict_from_jax,
)


class _NoDropout(flax.linen.Module):
    """Stands in for flax's Dropout: the identity."""

    rate: float = 0.0
    deterministic: bool | None = None

    @flax.linen.compact
    def __call__(self, x, deterministic=None, rng=None):
        return x


def _jax_initial_weights(cfg):
    """The JAX cycle's own initial trees (the same keys its pipeline draws),
    as numpy."""
    _, classifier = jax_build_classifier(cfg)
    seg_model = JaxDeepLabV3(num_classes=cfg.seg.num_classes,
                             backbone_depth=cfg.seg.backbone_depth,
                             width_multiplier=cfg.seg.width_multiplier,
                             bn_frozen=cfg.seg.bn_frozen)
    state, _ = jax_create_seg_state(seg_model, jax.random.PRNGKey(cfg.seed + 1),
                                    input_size=cfg.data.seg_size, lr=cfg.seg.lr,
                                    mesh=mesh_from_config(cfg.mesh))
    seg = {"params": state.params, "batch_stats": state.batch_stats}
    return jax.tree.map(np.asarray, classifier), jax.tree.map(np.asarray, seg)


def _spy(monkeypatch, module, name, record, key, keep, before=False):
    """Wrap ``module.name`` so that each call stores ``keep(args, result)``
    under ``record[key]`` (``before=True``: ``keep(args, None)`` before the
    call runs)."""
    real = getattr(module, name)

    def wrapper(*args, **kwargs):
        if before:
            record[key] = keep(args, None)
        out = real(*args, **kwargs)
        if not before:
            record[key] = keep(args, out)
        return out

    monkeypatch.setattr(module, name, wrapper)


def _with_dtype(cfg, dtype):
    """``cfg`` with both models' compute dtype set to ``dtype``."""
    return dataclasses.replace(cfg, classifier=dataclasses.replace(cfg.classifier, dtype=dtype),
                               seg=dataclasses.replace(cfg.seg, dtype=dtype))


def _run_cycles(dtype):
    """Both packages' cycles on ``smoke_config()`` with both models in the
    compute ``dtype``, from JAX's initial weights (float32 parameters in
    either dtype): (JAX's result, the port's, the spies' record)."""
    assert smoke_config().alternating.num_alternations == 1
    assert smoke_config().alternating.refine_repeats == 1
    jax_cfg = _with_dtype(jax_smoke_config(), dtype)
    port_cfg = _with_dtype(smoke_config(), dtype)
    record = {}
    mp = pytest.MonkeyPatch()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        mp.setattr(flax.linen, "Dropout", _NoDropout)
        mp.setattr(Dropout, "forward", lambda self, x: x)
        _spy(mp, jax_pseudo, "extract_cams", record, "jax_cams",
             lambda args, out: np.asarray(out.cams))
        _spy(mp, port_pseudo, "extract_cams", record, "port_cams",
             lambda args, out: out.cams.numpy())
        # the store as the cycle hands it to the alternating loop
        _spy(mp, jax_alternating, "run_alternating_training", record, "jax_store",
             lambda args, out: args[3].as_arrays()[1].copy(), before=True)
        _spy(mp, port_weakly, "run_alternating_training", record, "port_store",
             lambda args, out: args[1].as_arrays()[1].copy(), before=True)

        classifier, seg = _jax_initial_weights(jax_cfg)
        quiet = lambda *a, **k: None  # noqa: E731
        jax_result = jax_run_alternating(jax_cfg, log=quiet)
        port_result = port_weakly.run_weakly_supervised_alternating(
            port_cfg, log=quiet, device="cpu",
            classifier_weights=cam_classifier_state_dict_from_jax(classifier),
            seg_weights=deeplab_state_dict_from_jax(seg))
    finally:
        mp.undo()
        torch.set_num_threads(threads)
    return jax_result, port_result, record


@pytest.fixture(scope="module")
def cycles():
    return _run_cycles("float32")


@pytest.fixture(scope="module")
def cycles_bf16():
    return _run_cycles("bfloat16")


def test_fc_after_classifier_training(cycles):
    jax_result, port_result, _ = cycles
    fc = jax_result.classifier_variables["params"]["fc"]
    np.testing.assert_allclose(port_result.classifier.fc.weight.detach().numpy().T,
                               np.asarray(fc["kernel"]), atol=1e-5)
    np.testing.assert_allclose(port_result.classifier.fc.bias.detach().numpy(),
                               np.asarray(fc["bias"]), atol=1e-5)


def test_cams(cycles):
    _, _, record = cycles
    assert record["port_cams"].shape == record["jax_cams"].shape
    assert record["port_cams"].shape[0] == record["port_store"].shape[0] > 0
    np.testing.assert_allclose(record["port_cams"], record["jax_cams"], atol=2e-3)


def test_store_pseudo_masks(cycles):
    _, _, record = cycles
    got, want = record["port_store"], record["jax_store"]
    assert got.shape == want.shape
    assert 0.0 < want.mean() < 1.0  # masks with a foreground, not empty
    assert (got == want).mean() > 0.99


def test_masks_after_the_sweep(cycles):
    jax_result, port_result, _ = cycles
    _, want, jax_keys = jax_result.mask_store.as_arrays()
    _, got, port_keys = port_result.mask_store.as_arrays()
    assert list(port_keys) == list(jax_keys)
    assert got.shape == want.shape
    assert (got == want).mean() > 0.99


@pytest.mark.parametrize("key", ["iou", "alt_iou"])
def test_iou(cycles, key):
    jax_result, port_result, _ = cycles
    got, want = port_result.metrics[key], jax_result.metrics[key]
    assert np.isfinite(got) and np.isfinite(want)
    assert abs(got - want) < 0.01, (got, want)


# ---- the same cycle with classifier.dtype = seg.dtype = "bfloat16" --------------------
# bfloat16 rounds each side independently, so the stages are held to the
# composed cycle's looser gates: masks on at least 99 % of the pixels, IoU
# within 0.02.


def test_bf16_models_compute_in_bfloat16(cycles_bf16):
    _, port_result, _ = cycles_bf16
    assert port_result.classifier.compute_dtype == torch.bfloat16
    assert port_result.seg_state.model.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in port_result.seg_state.model.parameters())


def test_bf16_store_pseudo_masks(cycles_bf16):
    _, _, record = cycles_bf16
    got, want = record["port_store"], record["jax_store"]
    assert got.shape == want.shape and 0.0 < want.mean() < 1.0
    assert (got == want).mean() >= 0.99, (got == want).mean()


def test_bf16_masks_after_the_sweep(cycles_bf16):
    jax_result, port_result, _ = cycles_bf16
    _, want, jax_keys = jax_result.mask_store.as_arrays()
    _, got, port_keys = port_result.mask_store.as_arrays()
    assert list(port_keys) == list(jax_keys) and got.shape == want.shape
    assert (got == want).mean() >= 0.99, (got == want).mean()


@pytest.mark.parametrize("key", ["iou", "alt_iou"])
def test_bf16_iou(cycles_bf16, key):
    jax_result, port_result, _ = cycles_bf16
    got, want = port_result.metrics[key], jax_result.metrics[key]
    print(f"bf16 cycle {key}: port {got:.6f}, JAX {want:.6f}")
    assert np.isfinite(got) and np.isfinite(want)
    assert abs(got - want) <= 0.02, (got, want)
