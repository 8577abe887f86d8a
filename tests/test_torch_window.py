"""Port parity for the window-loss kernels' functions (ops/window.py): the
losses through the autograd Function on CPU tensors (the plain pair) against
the JAX package's Pallas kernels in interpret mode, values and gradients; and
the routing of CPU tensors away from the kernels."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weaklysuperviseddl_tpu.ops.pallas_window import (
    pallas_boundary_loss,
    pallas_local_normalized_cut_loss,
)
from weaklysuperviseddl_tpu_torch.ops.window import (
    fused_boundary_loss,
    fused_local_normalized_cut_loss,
    fused_window_sum,
    window_sum_cuda,
    window_sum_grad_cuda,
)

# the shapes of tests/test_fuzz_kernels.py: odd sizes, 3 classes, windows 3-7
FUZZ_SHAPES = [(11, 13, 2, 3), (16, 24, 3, 5), (9, 32, 2, 7)]


def _inputs(H, W, C, ws):
    rng = np.random.default_rng(H * W + C + ws)
    preds = rng.standard_normal((2, H, W, C)).astype(np.float32)
    images = rng.uniform(0, 1, (2, H, W, 3)).astype(np.float32)
    return preds, images


@pytest.mark.parametrize("loss", ["ncut", "boundary"])
@pytest.mark.parametrize("H,W,C,ws", FUZZ_SHAPES)
def test_fused_losses_match_jax_kernels(H, W, C, ws, loss):
    """Values rtol 1e-5, gradients rtol 1e-4 / atol 1e-7: the tolerances the
    JAX package holds its Pallas kernels to (tests/test_pallas_window.py)."""
    preds, images = _inputs(H, W, C, ws)
    if loss == "ncut":
        x = preds
        port_fn = lambda p, i: fused_local_normalized_cut_loss(p, i, sigma_color=0.07,
                                                               window_size=ws)
        jax_fn = lambda p, i: pallas_local_normalized_cut_loss(p, i, sigma_color=0.07,
                                                               window_size=ws, interpret=True)
    else:
        x = np.array(jax.nn.softmax(jnp.asarray(preds), axis=-1))
        port_fn = lambda p, i: fused_boundary_loss(p, i, sigma_color=0.1, sigma_space=4.0,
                                                   window_size=ws)
        jax_fn = lambda p, i: pallas_boundary_loss(p, i, sigma_color=0.1, sigma_space=4.0,
                                                   window_size=ws, interpret=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = port_fn(xt, torch.from_numpy(images))
    got.backward()
    want, want_grad = jax.value_and_grad(jax_fn)(jnp.asarray(x), jnp.asarray(images))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_grad), rtol=1e-4, atol=1e-7)


def test_images_get_no_gradient():
    preds, images = _inputs(11, 13, 2, 3)
    p = torch.from_numpy(preds).requires_grad_(True)
    im = torch.from_numpy(images).requires_grad_(True)
    fused_local_normalized_cut_loss(p, im, window_size=3).backward()
    assert p.grad is not None and float(p.grad.abs().sum()) > 0
    assert im.grad is None
    probs = torch.softmax(torch.from_numpy(preds), -1).requires_grad_(True)
    fused_boundary_loss(probs, im, window_size=3).backward()
    assert probs.grad is not None and im.grad is None


def test_cpu_tensors_never_launch_the_kernels():
    preds, images = _inputs(9, 32, 2, 7)
    probs = torch.softmax(torch.from_numpy(preds), -1).requires_grad_(True)
    im = torch.from_numpy(images)
    before = (window_sum_cuda.launches, window_sum_grad_cuda.launches)
    fused_window_sum(probs, im, 0.1, 5.0, 7).backward()
    assert probs.grad.shape == probs.shape
    assert (window_sum_cuda.launches, window_sum_grad_cuda.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        window_sum_cuda(probs.detach(), im, 0.1, 5.0, 7)
    with pytest.raises(ValueError, match="CUDA"):
        window_sum_grad_cuda(probs.detach(), im, 0.1, 5.0, 7)
    assert (window_sum_cuda.launches, window_sum_grad_cuda.launches) == before
