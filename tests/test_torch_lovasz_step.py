"""One Lovász-Softmax training step of DeepLabV3 against the JAX package's
(moved out of test_torch_lovasz.py so that xdist starts this heavy test
after the long JAX files)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_models import jax_deeplab_numpy
from test_torch_refine import single_torch_thread  # noqa: F401  (fixture)
from test_torch_segmentation import _assert_tree_close, _batch, no_dropout  # noqa: F401

from weaklysuperviseddl_tpu.models.torch_import import deeplab_variables
from weaklysuperviseddl_tpu.train.guard import apply_if_finite_fast
from weaklysuperviseddl_tpu.train.segmentation import make_seg_train_step
from weaklysuperviseddl_tpu_torch.train.guard import GuardedAdam
from weaklysuperviseddl_tpu_torch.train.segmentation import SegTrainState, seg_train_step

pytestmark = pytest.mark.usefixtures("single_torch_thread")


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

