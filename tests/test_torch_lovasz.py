"""Port parity for the Lovász losses and the segmentation step that uses one:
values and gradients against the JAX package on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_models import jax_deeplab_numpy
from test_torch_refine import single_torch_thread  # noqa: F401  (fixture)
from test_torch_segmentation import _assert_tree_close, _batch, no_dropout  # noqa: F401

from weaklysuperviseddl_tpu.losses import lovasz as jax_lovasz
from weaklysuperviseddl_tpu.models.torch_import import deeplab_variables
from weaklysuperviseddl_tpu.train.guard import apply_if_finite_fast
from weaklysuperviseddl_tpu.train.segmentation import make_seg_train_step
from weaklysuperviseddl_tpu_torch.losses import lovasz
from weaklysuperviseddl_tpu_torch.train.guard import GuardedAdam
from weaklysuperviseddl_tpu_torch.train.segmentation import SegTrainState, seg_train_step

pytestmark = pytest.mark.usefixtures("single_torch_thread")


def _softmax_case(seed=0, B=3, H=9, W=11, C=4):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, H, W, C)).astype(np.float32)
    probas = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    labels = rng.integers(0, C - 1, (B, H, W)).astype(np.int32)  # class C-1 absent
    labels[0, :3] = 255                                           # ignored where asked
    return probas.astype(np.float32), labels


def _value_and_grad_both(jax_fn, port_fn, x, *args):
    want, want_g = jax.value_and_grad(lambda p: jax_fn(p, *[jnp.asarray(a) for a in args]))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = port_fn(xt, *[torch.from_numpy(a) for a in args])
    (got_g,) = torch.autograd.grad(got, xt)
    return float(got.detach()), got_g.numpy(), float(want), np.asarray(want_g)


@pytest.mark.parametrize("classes", ["present", "all", (0, 2)])
@pytest.mark.parametrize("per_image", [False, True])
@pytest.mark.parametrize("ignore", [None, 255])
def test_lovasz_softmax_value_and_grad_match_jax(classes, per_image, ignore):
    """Values and gradients within 1e-5 (ROADMAP: losses within 1e-5)."""
    probas, labels = _softmax_case()
    if ignore is None:
        labels = np.where(labels == 255, 1, labels).astype(np.int32)
    kw = dict(classes=classes, per_image=per_image, ignore=ignore)
    got, got_g, want, want_g = _value_and_grad_both(
        lambda p, l: jax_lovasz.lovasz_softmax(p, l, **kw),
        lambda p, l: lovasz.lovasz_softmax(p, l, **kw), probas, labels)
    assert got == pytest.approx(want, abs=1e-5)
    np.testing.assert_allclose(got_g, want_g, atol=1e-5)


def test_lovasz_softmax_ties_pair_like_jax():
    """Many tied errors (probabilities on a coarse grid): the stable sort pairs
    each tied error with the same ground truth as JAX's sort_key_val."""
    rng = np.random.default_rng(1)
    p1 = rng.integers(0, 5, (2, 8, 8)).astype(np.float32) / 4
    probas = np.stack([1 - p1, p1], -1).astype(np.float32)
    labels = rng.integers(0, 2, (2, 8, 8)).astype(np.int32)
    got, got_g, want, want_g = _value_and_grad_both(
        jax_lovasz.lovasz_softmax, lovasz.lovasz_softmax, probas, labels)
    assert got == pytest.approx(want, abs=1e-5)
    np.testing.assert_allclose(got_g, want_g, atol=1e-5)


@pytest.mark.parametrize("per_image", [True, False])
@pytest.mark.parametrize("ignore", [None, 255])
def test_lovasz_hinge_value_and_grad_match_jax(per_image, ignore):
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((3, 7, 10)).astype(np.float32)
    labels = rng.integers(0, 2, (3, 7, 10)).astype(np.int32)
    if ignore is not None:
        labels[1, 2:4] = ignore
    kw = dict(per_image=per_image, ignore=ignore)
    got, got_g, want, want_g = _value_and_grad_both(
        lambda x, l: jax_lovasz.lovasz_hinge(x, l, **kw),
        lambda x, l: lovasz.lovasz_hinge(x, l, **kw), logits, labels)
    assert got == pytest.approx(want, abs=1e-5)
    np.testing.assert_allclose(got_g, want_g, atol=1e-5)


def test_lovasz_grad_and_stable_bce_match_jax():
    gt = (np.random.default_rng(3).uniform(size=50) > 0.6).astype(np.float32)
    np.testing.assert_allclose(lovasz.lovasz_grad(torch.from_numpy(gt)).numpy(),
                               np.asarray(jax_lovasz.lovasz_grad(jnp.asarray(gt))), atol=1e-6)
    rng = np.random.default_rng(4)
    x = (rng.standard_normal(40) * 30).astype(np.float32)  # large logits: the stable form
    y = (rng.uniform(size=40) > 0.5).astype(np.float32)
    got = lovasz.stable_bce(torch.from_numpy(x), torch.from_numpy(y))
    assert float(got) == pytest.approx(float(jax_lovasz.stable_bce(jnp.asarray(x),
                                                                   jnp.asarray(y))), rel=1e-6)


def test_lovasz_train_step_matches_jax(no_dropout):  # noqa: F811
    """One ``loss_fn="lovasz_softmax"`` step (padded last row weighted out):
    loss and BN statistics within 1e-5. The Lovász gradient is piecewise
    constant in the sort order of the errors, and errors that float noise
    separates by ~1e-7 can sort the other way in the two frameworks (the
    gradients then differ by up to a few % of a tensor's largest entry).
    Adam's first step moves each parameter by lr·g/(|g| + 1e-8), about
    lr·sign(g), so the parameters are held to 1e-5 wherever the two gradients
    have the same sign and both are zero or above 1e-6 in size (the CE step's
    test uses the same bound), and that must be at least 99 % of them."""
    model, variables = jax_deeplab_numpy(18, 0.25)
    port = no_dropout(variables)
    images, masks, valid = _batch(3)
    tx = apply_if_finite_fast(optax.adam(1e-4))
    params = jax.tree.map(jnp.asarray, variables["params"])
    stats = jax.tree.map(jnp.asarray, variables["batch_stats"])
    step = make_seg_train_step(model, tx, loss_fn="lovasz_softmax")
    w_params, w_stats, w_opt, w_loss = step(params, stats, tx.init(params),
                                            jnp.asarray(images), jnp.asarray(masks),
                                            jnp.asarray(valid), jax.random.PRNGKey(0))
    state = SegTrainState(port, GuardedAdam(port.parameters(), lr=1e-4))
    loss = seg_train_step(state, torch.from_numpy(images), torch.from_numpy(masks),
                          torch.from_numpy(valid), loss_fn="lovasz_softmax")
    assert float(loss) == pytest.approx(float(w_loss), abs=1e-5)
    back = deeplab_variables(port.state_dict())
    _assert_tree_close(back["batch_stats"], w_stats, atol=1e-5)
    names = [n for n, _ in port.named_parameters()]
    port_mu = deeplab_variables(dict(zip(names, state.optimizer.m)))["params"]
    checked = total = 0
    for got, want, g, w in zip(jax.tree.leaves(back["params"]), jax.tree.leaves(w_params),
                               jax.tree.leaves(port_mu), jax.tree.leaves(w_opt.inner_state[0].mu)):
        g, w = np.asarray(g) / 0.1, np.asarray(w) / 0.1  # Adam's μ = 0.1·g
        same = (np.sign(g) == np.sign(w)) & (
            ((g == 0) & (w == 0)) | ((np.abs(g) > 1e-6) & (np.abs(w) > 1e-6)))
        np.testing.assert_allclose(np.asarray(got)[same], np.asarray(want)[same], atol=1e-5)
        checked, total = checked + same.sum(), total + same.size
    assert checked / total > 0.99
    with pytest.raises(ValueError, match="loss_fn"):
        seg_train_step(state, torch.from_numpy(images), torch.from_numpy(masks),
                       torch.from_numpy(valid), loss_fn="dice")
