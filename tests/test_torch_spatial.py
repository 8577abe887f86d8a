"""The port's H-sharded window losses and refinement (``parallel/spatial.py``)
on 2 and 4 gloo ranks against the port's unsharded losses and refinement and
the JAX package's sharded ones (``weaklysuperviseddl_tpu/parallel/spatial.py``
on its virtual CPU mesh), with JAX's tests/test_spatial_sharding.py
tolerances: losses rtol 1e-5, the gradient rtol 1e-4 / atol 1e-7, the
refinement's loss rtol 1e-4 and masks > 0.999 equal, at 128² (JAX's 1024²
runs in chip_smoke.py). JAX's sharded functions are jitted here: run eagerly,
each shard_map takes minutes to trace on this CPU."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_mesh_cases import spatial_cases

from weaklysuperviseddl_tpu.parallel import make_mesh as jax_make_mesh
from weaklysuperviseddl_tpu.parallel.spatial import (
    spatial_sharded_boundary_loss as jax_boundary,
)
from weaklysuperviseddl_tpu.parallel.spatial import spatial_sharded_ncut_loss as jax_ncut
from weaklysuperviseddl_tpu.train.refine import refine_from_soft_predictions_sharded
from weaklysuperviseddl_tpu_torch.losses.window import boundary_loss, local_normalized_cut_loss
from weaklysuperviseddl_tpu_torch.ops.refine import refine_plain
from weaklysuperviseddl_tpu_torch.parallel.mesh import Ranks

RANKS = [2, 4]
REFINE = dict(lambda_boundary=0.1, threshold=0.5, lr=1e-2, num_steps=3, sigma_color=0.1,
              window_size=5, loss="ncut")


def _probs(rng, shape):
    p = rng.uniform(0.1, 1, shape).astype(np.float32)
    return p / p.sum(-1, keepdims=True)


def _jax_sharded(n, losses, grad, refine) -> dict:
    mesh = jax_make_mesh(data=n, model=1, devices=jax.devices()[:n])
    probs, images, probs3, images3 = (jnp.asarray(a) for a in losses)
    out = {
        "ncut": float(jax.jit(partial(jax_ncut, mesh=mesh, sigma_color=0.05,
                                      window_size=5))(probs, images)),
        "boundary": float(jax.jit(partial(jax_boundary, mesh=mesh, sigma_color=0.1,
                                          sigma_space=5.0, window_size=5))(probs, images)),
        "ncut_w3": float(jax.jit(partial(jax_ncut, mesh=mesh, sigma_color=0.1,
                                         window_size=3))(probs3, images3)),
    }
    logits, g_images = (jnp.asarray(a) for a in grad)
    out["grad"] = np.asarray(jax.jit(jax.grad(lambda lg: jax_ncut(
        jax.nn.softmax(lg, axis=-1), g_images, mesh, sigma_color=0.1, window_size=5)))(logits))
    if n == 4:  # one refinement compile: JAX's own test's shard count
        masks, loss = jax.jit(partial(refine_from_soft_predictions_sharded, mesh=mesh,
                                      **REFINE))(*(jnp.asarray(a) for a in refine))
        out["refined"], out["refine_loss"] = np.asarray(masks), float(loss)
    return out


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(0)
    losses = (_probs(rng, (2, 16, 16, 2)), rng.uniform(0, 1, (2, 16, 16, 3)).astype(np.float32),
              _probs(rng, (1, 16, 16, 2)), rng.uniform(0, 1, (1, 16, 16, 3)).astype(np.float32))
    grad = (rng.standard_normal((1, 16, 16, 2)).astype(np.float32),
            rng.uniform(0, 1, (1, 16, 16, 3)).astype(np.float32))
    refine = (_probs(rng, (1, 128, 128, 2)),
              rng.uniform(-1, 1, (1, 128, 128, 3)).astype(np.float32),
              (rng.uniform(0, 1, (1, 128, 128)) > 0.5).astype(np.int32))
    groups = {n: Ranks(spatial_cases, n, "cpu", n, losses, grad, refine, REFINE) for n in RANKS}
    try:
        jax_ref = {n: _jax_sharded(n, losses, grad, refine) for n in RANKS}
    finally:
        port = {n: g.join() for n, g in groups.items()}
    return {"losses": losses, "grad": grad, "refine": refine, "port": port, "jax": jax_ref}


def _unsharded_losses(losses) -> dict:
    probs, images, probs3, images3 = (torch.from_numpy(a) for a in losses)
    # the unsharded ncut softmaxes its input: log-probabilities give it the probabilities
    return {"ncut": float(local_normalized_cut_loss(probs.log(), images, 0.05, 5)),
            "boundary": float(boundary_loss(probs, images, 0.1, 5.0, 5)),
            "ncut_w3": float(local_normalized_cut_loss(probs3.log(), images3, 0.1, 3))}


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("loss", ["ncut", "boundary", "ncut_w3"])
def test_sharded_loss_matches_unsharded_and_jax(runs, n, loss):
    values = [r[loss] for r in runs["port"][n]]
    assert values == [values[0]] * n  # every rank holds the whole image's loss
    np.testing.assert_allclose(values[0], _unsharded_losses(runs["losses"])[loss], rtol=1e-5)
    np.testing.assert_allclose(values[0], runs["jax"][n][loss], rtol=1e-5)


@pytest.mark.parametrize("n", RANKS)
def test_sharded_gradient_matches_unsharded_and_jax(runs, n):
    """The halo's backward returns each halo row's gradient to its owner and
    the sums are forward-only: the ranks' rows together are the unsharded
    gradient, with nothing counted twice."""
    got = np.concatenate([r["grad_rows"] for r in runs["port"][n]], axis=1)
    logits, images = (torch.from_numpy(a) for a in runs["grad"])
    logits.requires_grad_(True)
    local_normalized_cut_loss(logits, images, 0.1, 5).backward()
    np.testing.assert_allclose(got, logits.grad.numpy(), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(got, runs["jax"][n]["grad"], rtol=1e-4, atol=1e-7)


@pytest.fixture(scope="module")
def unsharded_refinement(runs):
    return refine_plain(*(torch.from_numpy(a) for a in runs["refine"]), **REFINE)


@pytest.mark.parametrize("n", RANKS)
def test_sharded_refinement_matches_unsharded(runs, unsharded_refinement, n):
    port = runs["port"][n]
    masks = np.concatenate([r["refined_rows"] for r in port], axis=1)
    assert [r["refine_loss"] for r in port] == [port[0]["refine_loss"]] * n
    ref_masks, ref_loss = unsharded_refinement
    np.testing.assert_allclose(port[0]["refine_loss"], float(ref_loss), rtol=1e-4)
    agree = (masks == ref_masks.numpy()).mean()
    assert agree > 0.999, agree
    if n in runs["jax"] and "refined" in runs["jax"][n]:
        np.testing.assert_allclose(port[0]["refine_loss"], runs["jax"][n]["refine_loss"],
                                   rtol=1e-4)
        assert (masks == runs["jax"][n]["refined"]).mean() > 0.999
