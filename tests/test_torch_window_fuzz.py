"""The window losses through the autograd Function against the JAX
package's Pallas kernels in interpret mode at the two larger fuzz shapes of
tests/test_fuzz_kernels.py (test_torch_window.py holds the smallest, and the
check; these cases sit in a file of their own so that xdist starts them after
the long JAX files)."""

import pytest
from test_torch_window import FUZZ_SHAPES, check_fused_losses


@pytest.mark.parametrize("loss", ["ncut", "boundary"])
@pytest.mark.parametrize("H,W,C,ws", FUZZ_SHAPES[1:])
def test_fused_losses_match_jax_kernels(H, W, C, ws, loss):
    check_fused_losses(H, W, C, ws, loss)
