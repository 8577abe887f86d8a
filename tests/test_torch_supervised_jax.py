"""The supervised baseline's training and evaluators, and one bn_frozen step,
against the JAX package's (moved out of test_torch_supervised.py, whose
helpers they share by import, so that xdist starts these heavy tests after
the long JAX files)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_models import jax_deeplab_numpy
from test_torch_refine import single_torch_thread  # noqa: F401  (fixture)
from test_torch_segmentation import _batch, no_dropout  # noqa: F401  (fixture)
from test_torch_supervised import _Set, _eval_case
from torch_bridge import host_state

import weaklysuperviseddl_tpu.pipelines.supervised as jax_supervised
from weaklysuperviseddl_tpu.models.deeplabv3 import DeepLabV3 as JaxDeepLabV3
from weaklysuperviseddl_tpu.models.torch_import import deeplab_variables
from weaklysuperviseddl_tpu.train.guard import apply_if_finite_fast
from weaklysuperviseddl_tpu.train.segmentation import SegTrainState as JaxSegTrainState
from weaklysuperviseddl_tpu.train.segmentation import evaluate_multiclass as jax_eval_multiclass
from weaklysuperviseddl_tpu.train.segmentation import (
    evaluate_multiclass_dataset as jax_eval_multiclass_dataset,
)
from weaklysuperviseddl_tpu.train.segmentation import make_seg_train_step
import weaklysuperviseddl_tpu_torch.pipelines.supervised as supervised
from weaklysuperviseddl_tpu_torch.config import smoke_config
from weaklysuperviseddl_tpu_torch.data.loader import batches
from weaklysuperviseddl_tpu_torch.models.deeplabv3 import DeepLabV3
from weaklysuperviseddl_tpu_torch.models.jax_import import deeplab_state_dict_from_jax
from weaklysuperviseddl_tpu_torch.train.guard import GuardedAdam
from weaklysuperviseddl_tpu_torch.train.segmentation import (
    SegTrainState,
    create_seg_state,
    evaluate_multiclass,
    evaluate_multiclass_dataset,
    seg_train_step,
    train_segmentation_model,
)

pytestmark = pytest.mark.usefixtures("single_torch_thread")


def test_bn_frozen_ce_step_matches_jax(no_dropout):
    """One CE step of the bn_frozen model against the JAX package's, with the
    same weights and dropout the identity on both sides, at
    test_torch_segmentation.py's tolerances: loss rtol 1e-5, Adam's moments
    within 1e-3 of each tensor's largest value, parameters within 1e-5 where
    the gradient is zero or above 1e-6; the statistics unchanged on both
    sides. With the statistics frozen, more units sit at the ReLU's edge:
    0.66 % of the elements have 0 < |g| ≤ 1e-6 (0.06 % in the train-mode
    test), where float noise can flip Adam's first step, lr·sign(g); those
    are held to the 2·lr such a flip can give."""
    _, variables = jax_deeplab_numpy(18, 0.25)
    model = JaxDeepLabV3(num_classes=2, backbone_depth=18, width_multiplier=0.25,
                         bn_frozen=True)
    port = DeepLabV3(backbone_depth=18, width_multiplier=0.25, bn_frozen=True)
    port.load_state_dict(deeplab_state_dict_from_jax(variables), strict=True)
    port.classifier[0].project[3] = torch.nn.Identity()
    images, masks, valid = _batch(4)
    tx = apply_if_finite_fast(optax.adam(1e-4))
    params = jax.tree.map(jnp.asarray, variables["params"])
    stats = jax.tree.map(jnp.asarray, variables["batch_stats"])
    w_params, w_stats, w_opt, w_loss = make_seg_train_step(model, tx)(
        params, stats, tx.init(params), jnp.asarray(images), jnp.asarray(masks),
        jnp.asarray(valid), jax.random.PRNGKey(0))
    state = SegTrainState(port, GuardedAdam(port.parameters(), lr=1e-4))
    loss = seg_train_step(state, torch.from_numpy(images), torch.from_numpy(masks),
                          torch.from_numpy(valid))
    np.testing.assert_allclose(float(loss), float(w_loss), rtol=1e-5)
    back = deeplab_variables(port.state_dict())
    for got, was, theirs in zip(jax.tree.leaves(back["batch_stats"]),
                                jax.tree.leaves(variables["batch_stats"]),
                                jax.tree.leaves(w_stats)):
        np.testing.assert_array_equal(np.asarray(got), was)
        np.testing.assert_array_equal(np.asarray(theirs), was)
    names = [n for n, _ in port.named_parameters()]
    adam = w_opt.inner_state[0]
    for ours, theirs in ((state.optimizer.m, adam.mu), (state.optimizer.v, adam.nu)):
        got = jax.tree.leaves(deeplab_variables(dict(zip(names, ours)))["params"])
        for g, w in zip(got, jax.tree.leaves(theirs)):
            w = np.asarray(w)
            np.testing.assert_allclose(np.asarray(g), w, atol=1e-3 * np.abs(w).max())
    checked = total = 0
    for got, want, g in zip(jax.tree.leaves(back["params"]), jax.tree.leaves(w_params),
                            jax.tree.leaves(adam.mu)):
        g = np.abs(np.asarray(g)) / 0.1
        sure = (g == 0) | (g > 1e-6)
        got, want = np.asarray(got), np.asarray(want)
        np.testing.assert_allclose(got[sure], want[sure], atol=1e-5)
        np.testing.assert_allclose(got[~sure], want[~sure], atol=2e-4 + 1e-5)
        checked, total = checked + sure.sum(), total + sure.size
    assert checked / total > 0.99


def test_multiclass_evaluators_match_jax():
    """evaluate_multiclass_dataset (padded last batch) and evaluate_multiclass
    (a loader) against the JAX package's, within 1e-5."""
    model, state, port, images, trimaps = _eval_case()
    want = jax_eval_multiclass_dataset(model, state, jnp.asarray(images), jnp.asarray(trimaps),
                                       batch_size=3, seg_size=64)
    got = evaluate_multiclass_dataset(port, images, trimaps, batch_size=3, seg_size=64)
    np.testing.assert_allclose(got, want, atol=1e-5)
    loader = list(batches(_Set(images, trimaps), 2, pad_to_full=True))
    want = jax_eval_multiclass(model, state, loader, seg_size=64)
    got = evaluate_multiclass(port, loader, seg_size=64)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_supervised_training_matches_jax(monkeypatch, no_dropout):
    """run_supervised_training for 1 epoch from the JAX package's initial
    weights (bridged by patching each package's create_seg_state), dropout the
    identity: the summed epoch loss within rtol 1e-4 of JAX's, and the
    port's metrics within 1e-5 of the JAX evaluation of the same final
    weights."""
    cfg = smoke_config()
    _, variables = jax_deeplab_numpy(18, 0.25)

    def jax_start(model, rng, input_size, lr, **kw):
        tx = apply_if_finite_fast(optax.adam(lr))
        params = jax.tree.map(jnp.asarray, variables["params"])
        stats = jax.tree.map(jnp.asarray, variables["batch_stats"])
        return JaxSegTrainState(params, stats, tx.init(params)), tx

    def port_start(model, seed, lr, device=None):
        model.load_state_dict(deeplab_state_dict_from_jax(variables), strict=True)
        model.classifier[0].project[3] = torch.nn.Identity()
        return SegTrainState(model.to(device), GuardedAdam(model.parameters(), lr=lr))

    losses = {}

    def recording(name, train):
        def wrapped(*args, **kw):
            out = train(*args, **kw)
            losses[name] = out[1]
            return out
        return wrapped

    monkeypatch.setattr(jax_supervised, "create_seg_state", jax_start)
    monkeypatch.setattr(jax_supervised, "train_segmentation_model",
                        recording("jax", jax_supervised.train_segmentation_model))
    monkeypatch.setattr(supervised, "create_seg_state", port_start)
    monkeypatch.setattr(supervised, "train_segmentation_model",
                        recording("port", supervised.train_segmentation_model))
    import weaklysuperviseddl_tpu.config as jax_config

    jax_cfg = jax_config.smoke_config()
    _, want = jax_supervised.run_supervised_training(jax_cfg, num_epochs=1, test_runs=1,
                                                     log=lambda s: None)
    logs = []
    state, got = supervised.run_supervised_training(cfg, num_epochs=1, test_runs=2,
                                                    log=logs.append, device="cpu")
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=1e-4)
    assert set(got) == set(want) == {"acc_mean", "acc_std", "iou_mean", "iou_std"}
    assert got["acc_std"] == got["iou_std"] == 0.0
    assert any("Final Test Results:" in s for s in logs)

    # the JAX evaluation of the port's final weights, on the same test set
    back = deeplab_variables(host_state(state.model.state_dict()))
    jax_model = JaxDeepLabV3(num_classes=2, backbone_depth=18, width_multiplier=0.25)
    test_images, test_trimaps = (a.numpy() for a in supervised.load_test_arrays(cfg, "cpu"))
    acc, iou = jax_eval_multiclass_dataset(
        jax_model, JaxSegTrainState(back["params"], back["batch_stats"], None),
        jnp.asarray(test_images), jnp.asarray(test_trimaps), batch_size=cfg.data.eval_batch_size,
        seg_size=cfg.data.seg_size)
    np.testing.assert_allclose([got["acc_mean"], got["iou_mean"]], [acc, iou], atol=1e-5)

