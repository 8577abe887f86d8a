"""The pseudo-mask stage through masks_from_cams with the CRF's grid, lattice
and RFF backends against the JAX package's (moved out of
test_torch_crf_backends.py, whose helpers they share by import, so that
xdist starts these heavy cases after the long JAX files)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_crf_backends import REFERENCE, jax_draws
from test_torch_refine import single_torch_thread  # noqa: F401  (fixture)

from weaklysuperviseddl_tpu.masks.pseudo import ResidentCams as JaxResidentCams
from weaklysuperviseddl_tpu.masks.pseudo import masks_from_cams as jax_masks_from_cams
from weaklysuperviseddl_tpu_torch.data.synthetic import synthetic_pet_arrays
from weaklysuperviseddl_tpu_torch.masks import densecrf
from weaklysuperviseddl_tpu_torch.masks.pseudo import ResidentCams, masks_from_cams
from weaklysuperviseddl_tpu_torch.ops.bilateral import rff_basis

pytestmark = pytest.mark.usefixtures("single_torch_thread")


@pytest.mark.parametrize("backend", ["grid", "lattice", "rff"])
def test_masks_from_cams_with_crf_agrees_with_jax(backend, monkeypatch):
    """As test_torch_crf.py's test of the "subsampled" backend: 48² CAMs
    (noisy, smoothed trimap foregrounds) over raw 56² images at the
    reference's CRF parameters, the last batch padded, mask agreement >=
    0.999 (the two packages' resizes differ by up to 1e-6)."""
    n, size = 3, 48
    raw, _, _ = synthetic_pet_arrays(n, image_size=56, seed=5)
    raw_u8 = (raw * 255).astype(np.uint8)
    _, _, tri64 = synthetic_pet_arrays(n, image_size=size, seed=5)
    rng = np.random.default_rng(6)
    fg = (tri64 == 1).astype(np.float32)
    cams = np.clip(0.7 * fg + rng.uniform(-0.25, 0.35, fg.shape), 0, 1).astype(np.float32)
    store = np.zeros((n, size, size, 3), np.uint8)
    if backend == "rff":
        monkeypatch.setattr(densecrf, "rff_basis",
                            functools.partial(rff_basis, draws=jax_draws(5, 4096)))
    kw = dict(cam_thresh=0.3, keep_largest_masks=True, use_crf=True,
              crf_kwargs=dict(REFERENCE, bilat_backend=backend))
    want = jax_masks_from_cams(JaxResidentCams(jnp.asarray(raw_u8), jnp.asarray(cams),
                                               jnp.asarray(store), size, 2), **kw)
    got = masks_from_cams(ResidentCams(torch.from_numpy(raw_u8), torch.from_numpy(cams),
                                       torch.from_numpy(store), size, 2), **kw)
    _, w_masks, w_keys = want.as_arrays()
    _, g_masks, g_keys = got.as_arrays()
    assert g_keys == w_keys and len(g_keys) == n
    assert (g_masks == w_masks).mean() >= 0.999
    assert 0.01 < g_masks.mean() < 0.99

