"""Port parity for the CRF pseudo-mask path: the exact Gaussian filter, dense-CRF
mean-field inference ("attention" and "subsampled"), ``apply_dense_crf`` and
``masks_from_cams(use_crf=True)``, against the JAX package on the same numpy
inputs. Sizes stay at or below 64², where the JAX functions compute the exact
filter off the TPU (above it they switch to their bilateral grid). The grid,
lattice and RFF backends are in test_torch_crf_backends.py and
test_torch_lattice.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_densecrf import PARAMS, make_case
from test_torch_refine import single_torch_thread  # noqa: F401  (fixture)

from weaklysuperviseddl_tpu.masks.densecrf import apply_dense_crf as jax_apply_dense_crf
from weaklysuperviseddl_tpu.masks.densecrf import densecrf_inference as jax_densecrf
from weaklysuperviseddl_tpu.masks.pseudo import ResidentCams as JaxResidentCams
from weaklysuperviseddl_tpu.masks.pseudo import masks_from_cams as jax_masks_from_cams
from weaklysuperviseddl_tpu.ops.pallas_bilateral import gaussian_filter_xla_cross
from weaklysuperviseddl_tpu_torch.data.synthetic import synthetic_pet_arrays
from weaklysuperviseddl_tpu_torch.masks.densecrf import apply_dense_crf, densecrf_inference
from weaklysuperviseddl_tpu_torch.masks.pseudo import ResidentCams, masks_from_cams
from weaklysuperviseddl_tpu_torch.ops.bilateral import (
    gaussian_filter,
    gaussian_filter_cross,
    gaussian_filter_plain_cross,
    gaussian_filter_rect,
)

pytestmark = pytest.mark.usefixtures("single_torch_thread")

# the reference's CRF parameters (AlternatingDirectionCutLoss.py:183-204)
REFERENCE = dict(gauss_sxy=1.0, gauss_compat=2.0, bilat_sxy=50.0, bilat_srgb=5.0,
                 bilat_compat=10.0, n_iters=5)


def _ragged_case(C=2):
    rng = np.random.default_rng(7)
    Nq, Nk = 531, 187
    fq = rng.uniform(0, 20, (Nq, 5)).astype(np.float32)
    fk = rng.uniform(0, 20, (Nk, 5)).astype(np.float32)
    v = rng.uniform(size=(Nk, C)).astype(np.float32)
    return fq, fk, v


@pytest.mark.parametrize("C", [1, 2, 3])
def test_plain_filter_matches_jax_xla_cross(C):
    """rtol 1e-4, atol 1e-5: JAX's test holds its XLA filter to the literal
    sum at this tolerance. The port sums squared differences, so it is also
    held to the float64 sum, 100× tighter."""
    fq, fk, v = _ragged_case(C)
    want = np.asarray(gaussian_filter_xla_cross(jnp.asarray(fq), jnp.asarray(fk), jnp.asarray(v)))
    got = gaussian_filter_cross(torch.from_numpy(fq), torch.from_numpy(fk), torch.from_numpy(v))
    assert got.shape == (531, C) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    d2 = ((fq[:, None, :].astype(np.float64) - fk[None, :, :]) ** 2).sum(-1)
    gold = np.exp(-0.5 * d2) @ v.astype(np.float64)
    np.testing.assert_allclose(got.numpy(), gold, rtol=1e-6, atol=1e-7)


def test_plain_filter_batch_equals_per_image_and_square_form():
    rng = np.random.default_rng(3)
    fq = torch.from_numpy(rng.uniform(0, 8, (3, 70, 20)).astype(np.float32))
    fk = torch.from_numpy(rng.uniform(0, 8, (3, 33, 20)).astype(np.float32))
    v = torch.from_numpy(rng.uniform(size=(3, 33, 11)).astype(np.float32))
    batch = gaussian_filter_cross(fq, fk, v)
    for b in range(3):
        torch.testing.assert_close(batch[b], gaussian_filter_plain_cross(fq[b], fk[b], v[b]),
                                   rtol=0, atol=0)
    assert gaussian_filter_rect is gaussian_filter_cross
    vq = torch.from_numpy(rng.uniform(size=(3, 70, 2)).astype(np.float32))
    torch.testing.assert_close(gaussian_filter(fq, vq), gaussian_filter_cross(fq, fq, vq),
                               rtol=0, atol=0)
    with pytest.raises(ValueError):
        gaussian_filter_cross(fq, fk[:, :, :5], v)


def test_plain_filter_fp64_parity_at_reference_magnitudes():
    """Colour features up to 255/σ_rgb ≈ 51 (‖f‖² ≈ 7e3): max error below
    1e-3 of the largest output, as JAX's fp64 test holds its XLA filter."""
    rng = np.random.default_rng(0)
    S = 32
    img = rng.integers(0, 255, (S, S, 3)).astype(np.float64)
    yy = np.arange(S)[:, None] / 50.0
    xx = np.arange(S)[None, :] / 50.0
    feats = np.stack([np.broadcast_to(xx, (S, S)), np.broadcast_to(yy, (S, S))]
                     + [img[..., c] / 5.0 for c in range(3)], -1).reshape(-1, 5)
    v = rng.uniform(0, 1, (S * S, 2))
    gold = np.exp(-0.5 * ((feats[:, None, :] - feats[None, :, :]) ** 2).sum(-1)) @ v
    f32 = torch.from_numpy(feats.astype(np.float32))
    got = gaussian_filter(f32, torch.from_numpy(v.astype(np.float32))).numpy()
    assert np.abs(got - gold).max() / np.abs(gold).max() < 1e-3


def _crf_pair(probs, images, **kw):
    want = np.asarray(jax_densecrf(jnp.asarray(probs), jnp.asarray(images), **kw))
    got = densecrf_inference(torch.from_numpy(probs), torch.from_numpy(images), **kw).numpy()
    return got, want


@pytest.mark.parametrize("backend", ["attention", "subsampled"])
def test_densecrf_matches_jax_on_make_case(backend):
    """24², two images from test_densecrf.make_case: max |ΔQ| ≤ 1e-4 and the
    argmax equal everywhere."""
    cases = [make_case(seed) for seed in (0, 1)]
    images = np.stack([c[0] for c in cases]).astype(np.float32)
    probs = np.stack([c[2] for c in cases]).astype(np.float32)
    got, want = _crf_pair(probs, images, bilat_backend=backend, **PARAMS)
    assert got.shape == (2, 24, 24, 2)
    assert np.abs(got - want).max() <= 1e-4
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def _filter_fp64(feats_q, feats_k, values):
    """The exact filter in float64: the golden of the CRF tests below."""
    fq, fk = feats_q.double(), feats_k.double()
    d2 = sum((fq[:, :, None, k] - fk[:, None, :, k]) ** 2 for k in range(fq.shape[-1]))
    return (torch.exp(-0.5 * d2) @ values.double()).float()


@pytest.mark.parametrize("backend", ["attention", "subsampled"])
def test_densecrf_matches_jax_at_reference_params(backend, monkeypatch):
    """48×40 synthetic pets (ragged against the stride-2 key grid), the
    reference's σ and compat. JAX's filter off the TPU expands the square
    (‖fq‖² + ‖fk‖² − 2 fq·fk at ‖f‖² ≈ 7e3), which puts about 1e-3 into the
    exponent: its Q is up to ~1e-3 from the same CRF with a float64 filter
    (8e-3 on random colours), while the port, summing squared differences,
    stays within 1e-4 of it. So: the port within 1e-4 of the float64 CRF,
    within 1e-4 of JAX beyond JAX's own distance from it, and the argmax
    equal to JAX's everywhere."""
    from weaklysuperviseddl_tpu_torch.masks import densecrf

    images, _, trimaps = synthetic_pet_arrays(2, image_size=48, seed=2)
    images = (images[:, :, :40] * 255).astype(np.float32)
    rng = np.random.default_rng(2)
    cam = (trimaps[:, :, :40] == 1) * 0.6 + rng.uniform(-0.3, 0.3, (2, 48, 40))
    cam = np.clip(cam, 0, 1).astype(np.float32)
    probs = np.clip(np.stack([1 - cam, cam], -1), 1e-8, 1.0)
    got, want = _crf_pair(probs, images, bilat_backend=backend, **REFERENCE)
    monkeypatch.setattr(densecrf, "gaussian_filter_cross", _filter_fp64)
    gold = densecrf_inference(torch.from_numpy(probs), torch.from_numpy(images),
                              bilat_backend=backend, **REFERENCE).numpy()
    assert np.abs(got - gold).max() <= 1e-4
    assert np.abs(got - want).max() <= np.abs(want - gold).max() + 1e-4
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_array_equal(got.argmax(-1), gold.argmax(-1))


@pytest.mark.parametrize("backend", ["attention", "subsampled"])
def test_apply_dense_crf_masks_equal_jax(backend):
    """Images in [0,1] take the ×255 branch (the max over the whole batch)."""
    rng = np.random.default_rng(5)
    images, _, trimaps = synthetic_pet_arrays(3, image_size=40, seed=2)
    cams = np.clip((trimaps == 1) * 0.6 + rng.uniform(-0.3, 0.3, trimaps.shape), 0, 1)
    cams = cams.astype(np.float32)
    want = np.asarray(jax_apply_dense_crf(jnp.asarray(images), jnp.asarray(cams),
                                          bilat_backend=backend))
    got = apply_dense_crf(torch.from_numpy(images), torch.from_numpy(cams),
                          bilat_backend=backend)
    assert got.dtype == torch.uint8 and got.shape == (3, 40, 40)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.05 < want.mean() < 0.95  # the masks have structure


def test_densecrf_rejects_unknown_backend():
    probs = np.full((1, 8, 8, 2), 0.5, np.float32)
    with pytest.raises(ValueError, match="unknown"):
        densecrf_inference(torch.from_numpy(probs), torch.zeros((1, 8, 8, 3)),
                           bilat_backend="exact")


def test_masks_from_cams_with_crf_agrees_with_jax():
    """64² CAMs (noisy, smoothed trimap foregrounds) over raw 72² images, at
    the reference's CRF parameters with the config's "subsampled" backend:
    agreement ≥ 0.999 (the two packages' resizes differ by up to 1e-6)."""
    n, size = 5, 64
    raw, _, trimaps = synthetic_pet_arrays(n, image_size=72, seed=4)
    raw_u8 = (raw * 255).astype(np.uint8)
    _, _, tri64 = synthetic_pet_arrays(n, image_size=size, seed=4)
    rng = np.random.default_rng(6)
    fg = (tri64 == 1).astype(np.float32)
    cams = np.clip(0.7 * fg + rng.uniform(-0.25, 0.35, fg.shape), 0, 1).astype(np.float32)
    store = np.zeros((n, size, size, 3), np.uint8)
    kw = dict(cam_thresh=0.3, keep_largest_masks=True, use_crf=True,
              crf_kwargs=dict(REFERENCE, bilat_backend="subsampled", key_stride=2))
    want = jax_masks_from_cams(JaxResidentCams(jnp.asarray(raw_u8), jnp.asarray(cams),
                                               jnp.asarray(store), size, 2), **kw)
    got = masks_from_cams(ResidentCams(torch.from_numpy(raw_u8), torch.from_numpy(cams),
                                       torch.from_numpy(store), size, 2), **kw)
    _, w_masks, w_keys = want.as_arrays()
    _, g_masks, g_keys = got.as_arrays()
    assert g_keys == w_keys and len(g_keys) == n
    assert (g_masks == w_masks).mean() >= 0.999
    assert 0.05 < g_masks.mean() < 0.95
    # the CRF changes the masks: without it the thresholded noise stays
    plain = masks_from_cams(ResidentCams(torch.from_numpy(raw_u8), torch.from_numpy(cams),
                                         torch.from_numpy(store), size, 2), cam_thresh=0.3)
    assert (plain.as_arrays()[1] != g_masks).mean() > 0.01
