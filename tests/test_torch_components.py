"""Port parity: connected components (masks/components.py, the plain version of
the CUDA kernel) against the JAX package's XLA function, its Pallas kernel in
interpret mode, and scipy. Labels must be exactly equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from weaklysuperviseddl_tpu.masks import components as jax_cc
from weaklysuperviseddl_tpu.ops.pallas_cc import (
    pallas_keep_largest_batch,
    pallas_label_components_batch,
)
from weaklysuperviseddl_tpu_torch.masks import synthetic
from weaklysuperviseddl_tpu_torch.masks.components import (
    keep_largest,
    keep_largest_batch,
    label_components,
)


def families(shape, seed=0):
    return {name: synthetic.family(name, 3, shape, seed) for name in FAMILIES}


def scipy_min_index_labels(mask):
    """scipy.ndimage.label with a 3x3 structure, relabelled to each
    component's minimal linear index (bg = -1)."""
    lab, n = ndimage.label(mask, structure=np.ones((3, 3), int))
    out = np.full(mask.shape, -1, np.int32)
    flat = lab.ravel()
    for k in range(1, n + 1):
        idx = np.flatnonzero(flat == k)
        out.ravel()[idx] = idx.min()
    return out


FAMILIES = synthetic.FAMILIES
SHAPES = [(24, 40), (33, 17)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("family", FAMILIES)
def test_labels_match_xla_and_scipy(family, shape):
    masks = families(shape)[family]
    got = label_components(torch.from_numpy(masks)).numpy()
    assert got.dtype == np.int32
    for i, m in enumerate(masks):
        np.testing.assert_array_equal(got[i], np.asarray(jax_cc.label_components(jnp.asarray(m))))
        np.testing.assert_array_equal(got[i], scipy_min_index_labels(m))
        # the [H,W] form gives the same labels
        np.testing.assert_array_equal(label_components(torch.from_numpy(m)).numpy(), got[i])


@pytest.mark.parametrize("family", FAMILIES)
def test_labels_and_keep_largest_match_pallas_interpret(family):
    masks = families((16, 24), seed=1)[family]
    got = label_components(torch.from_numpy(masks)).numpy()
    want = np.asarray(pallas_label_components_batch(jnp.asarray(masks), interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        keep_largest_batch(torch.from_numpy(masks)).numpy(),
        np.asarray(pallas_keep_largest_batch(jnp.asarray(masks), interpret=True)))


@pytest.mark.parametrize("family", FAMILIES)
def test_keep_largest_batch_matches_xla(family):
    masks = families((40, 36), seed=2)[family]
    got = keep_largest_batch(torch.from_numpy(masks))
    assert got.dtype == torch.uint8 and got.shape == masks.shape
    want = np.asarray(jax_cc.keep_largest_batch(jnp.asarray(masks), backend="xla"))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(keep_largest(torch.from_numpy(masks[0])).numpy(), want[0])


def test_keep_largest_ties_go_to_smallest_label():
    m = np.zeros((1, 8, 8), np.uint8)
    m[0, 5:7, 5:7] = 1  # later component, same size
    m[0, 1:3, 1:3] = 1  # smallest root index wins
    got = keep_largest_batch(torch.from_numpy(m)).numpy()[0]
    assert got.sum() == 4 and got[1, 1] == 1 and got[5, 5] == 0
    np.testing.assert_array_equal(got, np.asarray(jax_cc.keep_largest(jnp.asarray(m[0]))))


def test_max_iters_matches_jax_before_convergence():
    """The plain version keeps the JAX round limit (the CUDA kernel always
    reaches the fixed point): cut short, both stop at the same labels."""
    m = synthetic.snake((24, 24))
    for it in (1, 3):
        got = label_components(torch.from_numpy(m), max_iters=it).numpy()
        want = np.asarray(jax_cc.label_components(jnp.asarray(m), max_iters=it))
        np.testing.assert_array_equal(got, want)
    assert len(np.unique(got[got >= 0])) > 1  # not converged after 3 rounds


def test_kernel_backend_raises_on_cpu_tensor():
    masks = torch.ones((1, 8, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        keep_largest_batch(masks, backend="kernel")
    with pytest.raises(ValueError, match="unknown backend"):
        keep_largest_batch(masks, backend="pallas")
    # "auto" on a CPU tensor takes the plain version
    np.testing.assert_array_equal(keep_largest_batch(masks).numpy(), masks.numpy())
