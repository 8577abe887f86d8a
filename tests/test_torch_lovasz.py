"""Port parity for the Lovász losses: values and gradients against the JAX
package on the same numpy inputs (the segmentation step that uses one is in
``test_torch_lovasz_step.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_refine import single_torch_thread  # noqa: F401  (fixture)

from weaklysuperviseddl_tpu.losses import lovasz as jax_lovasz
from weaklysuperviseddl_tpu_torch.losses import lovasz

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


