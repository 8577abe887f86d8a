"""Port parity for segmentation training: one CE train step (dropout the
identity on both sides), BatchNorm's running statistics in training (flax's
biased variance, the ASPP pooling branch at batch 4 included), the
non-finite-gradient guard, and the test-set evaluation."""

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_models import jax_deeplab_numpy, port_from_jax
from test_torch_refine import single_torch_thread  # noqa: F401  (fixture)

from weaklysuperviseddl_tpu.models.torch_import import deeplab_variables
from weaklysuperviseddl_tpu.train.guard import apply_if_finite_fast
from weaklysuperviseddl_tpu.train.segmentation import SegTrainState as JaxSegTrainState
from weaklysuperviseddl_tpu.train.segmentation import (
    evaluate_segmentation_dataset as jax_evaluate,
)
from weaklysuperviseddl_tpu.train.segmentation import make_seg_train_step
from weaklysuperviseddl_tpu_torch.models.resnet import BatchNorm2d
from weaklysuperviseddl_tpu_torch.train.guard import GuardedAdam
from weaklysuperviseddl_tpu_torch.train.segmentation import (
    SegTrainState,
    evaluate_segmentation_dataset,
    seg_train_step,
)


pytestmark = pytest.mark.usefixtures("single_torch_thread")


class _NoDropout(flax.linen.Module):
    """Stands in for flax's Dropout inside a test: the identity."""

    rate: float = 0.0
    deterministic: bool | None = None

    @flax.linen.compact
    def __call__(self, x, deterministic=None, rng=None):
        return x


@pytest.fixture
def no_dropout(monkeypatch):
    """Dropout as the identity on both sides: JAX's random bits cannot be
    reproduced, so training steps are compared without it."""
    monkeypatch.setattr(flax.linen, "Dropout", _NoDropout)

    def port(variables):
        model = port_from_jax(variables, 18, 0.25)
        model.classifier[0].project[3] = torch.nn.Identity()
        return model

    return port


def _batch(seed=0, B=4, size=64):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((B, size, size, 3)).astype(np.float32)
    masks = rng.integers(0, 3, (B, size, size)).astype(np.int32)  # clamped to {0,1} by the step
    valid = np.arange(B) < B - 1                                   # a padded last row
    return images, masks, valid


def _assert_tree_close(got, want, atol):
    g = jax.tree_util.tree_leaves_with_path(got)
    w = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, err_msg=str(path))


def test_ce_train_step_matches_jax(no_dropout):
    """Loss rtol 1e-5; Adam's moments (the gradients) within 1e-3 of each
    tensor's largest value (fp32 sums over the batch taken in another order,
    which also changes with the thread count: 2e-4 observed); BN stats and
    parameters within 1e-5. Adam's first step moves each parameter by
    lr·g/(|g| + 1e-8), about lr·sign(g): where |g| is below 1e-6 the float
    noise of the two frameworks can flip that sign, so parameters are held to
    1e-5 where the gradient is exactly zero or above 1e-6 (all but a few
    elements, counted below)."""
    model, variables = jax_deeplab_numpy(18, 0.25)
    port = no_dropout(variables)
    images, masks, valid = _batch()
    tx = apply_if_finite_fast(optax.adam(1e-4))
    params = jax.tree.map(jnp.asarray, variables["params"])
    stats = jax.tree.map(jnp.asarray, variables["batch_stats"])
    step = make_seg_train_step(model, tx)
    w_params, w_stats, w_opt, w_loss = step(params, stats, tx.init(params),
                                            jnp.asarray(images), jnp.asarray(masks),
                                            jnp.asarray(valid), jax.random.PRNGKey(0))
    state = SegTrainState(port, GuardedAdam(port.parameters(), lr=1e-4))
    loss = seg_train_step(state, torch.from_numpy(images), torch.from_numpy(masks),
                          torch.from_numpy(valid))
    np.testing.assert_allclose(float(loss), float(w_loss), rtol=1e-5)
    back = deeplab_variables(port.state_dict())
    _assert_tree_close(back["batch_stats"], w_stats, atol=1e-5)
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
        np.testing.assert_allclose(np.asarray(got)[sure], np.asarray(want)[sure], atol=1e-5)
        checked, total = checked + sure.sum(), total + sure.size
    assert checked / total > 0.999
    assert state.optimizer.count == 1 and state.step == 1


def test_train_mode_forward_updates_bn_stats_as_flax(no_dropout):
    """One train-mode forward at batch 4: every BN's running mean and
    variance as flax computes them. The ASPP pooling BN sees 4 values per
    channel, where torch's own unbiased update would be 4/3 too large."""
    model, variables = jax_deeplab_numpy(18, 0.25)
    port = no_dropout(variables).train()
    images, _, _ = _batch(1)
    _, updates = model.apply(variables, jnp.asarray(images), train=True,
                             mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
    with torch.no_grad():
        port(torch.from_numpy(images).permute(0, 3, 1, 2))
    back = deeplab_variables(port.state_dict())
    _assert_tree_close(back["batch_stats"], updates["batch_stats"], atol=1e-5)
    assert isinstance(port.classifier[0].convs[4][2], BatchNorm2d)
    # torch's unbiased update would add a third of the batch term (n = 4)
    old = variables["batch_stats"]["aspp"]["pool_bn"]["var"]
    new = np.asarray(updates["batch_stats"]["aspp"]["pool_bn"]["var"])
    unbiased_update = new + (new - 0.9 * old) / 3
    assert np.abs(unbiased_update - new).max() > 1e-3  # far outside the 1e-5 held above


def test_bn_eval_path_is_torch_batchnorm_bit_for_bit():
    """The serving path's eval outputs are unchanged by the repaired BN."""
    rng = np.random.default_rng(2)
    ours, theirs = BatchNorm2d(6), torch.nn.BatchNorm2d(6)
    for bn in (ours, theirs):
        with torch.no_grad():
            bn.running_mean.copy_(torch.from_numpy(rng.standard_normal(6).astype(np.float32)))
            bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2, 6).astype(np.float32)))
            bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 2, 6).astype(np.float32)))
        rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((3, 6, 5, 7)).astype(np.float32))
    assert torch.equal(ours.eval()(x), theirs.eval()(x))


def test_guard_skips_a_nan_step_and_keeps_the_adam_state(no_dropout):
    _, variables = jax_deeplab_numpy(18, 0.25)
    port = no_dropout(variables)
    state = SegTrainState(port, GuardedAdam(port.parameters(), lr=1e-4))
    images, masks, valid = _batch(2)
    before = [p.detach().clone() for p in port.parameters()]
    bad = images.copy()
    bad[0, 0, 0, 0] = np.nan
    loss = seg_train_step(state, torch.from_numpy(bad), torch.from_numpy(masks),
                          torch.from_numpy(valid))
    opt = state.optimizer
    assert not np.isfinite(float(loss))
    assert opt.count == 0 and opt.notfinite_count == 1 and opt.total_notfinite == 1
    assert all(torch.equal(p, b) for p, b in zip(port.parameters(), before))
    assert all(not m.any() for m in opt.m) and all(not v.any() for v in opt.v)
    seg_train_step(state, torch.from_numpy(images), torch.from_numpy(masks),
                   torch.from_numpy(valid))
    assert opt.count == 1 and opt.notfinite_count == 0 and opt.total_notfinite == 1
    assert any(not torch.equal(p, b) for p, b in zip(port.parameters(), before))


def test_evaluate_segmentation_dataset_matches_jax():
    model, variables = jax_deeplab_numpy(18, 0.25, seed=3)
    port = port_from_jax(variables, 18, 0.25)
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, (5, 56, 56, 3)).astype(np.uint8)
    trimaps = rng.integers(1, 4, (5, 56, 56)).astype(np.uint8)
    want = jax_evaluate(model, JaxSegTrainState(variables["params"], variables["batch_stats"],
                                                None),
                        jnp.asarray(images), jnp.asarray(trimaps), batch_size=3, seg_size=64,
                        eval_size=48)
    got = evaluate_segmentation_dataset(port, images, trimaps, batch_size=3, seg_size=64,
                                        eval_size=48)
    assert got == pytest.approx(want, abs=1e-6)
