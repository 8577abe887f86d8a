"""Port parity for the CRF's "grid" and "rff" backends against the JAX package
on the same numpy inputs (``masks_from_cams`` through each of the grid,
lattice and RFF backends is in ``test_torch_crf_masks.py``).

JAX's RFF draws come from ``PRNGKey(7)`` through threefry, which torch cannot
reproduce: the tests draw them with the same ``jax.random`` calls as JAX's
``rff_basis`` and hand them to the port (``rff_basis(draws=...)``, and
through a patched ``densecrf.rff_basis`` for the CRF). Off the TPU, JAX's
"attention" and "subsampled" run its grid above 64², so at 72² the port's
grid is also held to what JAX's "attention" computes there."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_densecrf import PARAMS, make_case
from test_torch_refine import single_torch_thread  # noqa: F401  (fixture)

from weaklysuperviseddl_tpu.masks.densecrf import densecrf_inference as jax_densecrf
from weaklysuperviseddl_tpu.ops.pallas_bilateral import gaussian_filter_rff as jax_filter_rff
from weaklysuperviseddl_tpu.ops.pallas_bilateral import rff_basis as jax_rff_basis
from weaklysuperviseddl_tpu_torch.data.synthetic import synthetic_pet_arrays
from weaklysuperviseddl_tpu_torch.masks import densecrf
from weaklysuperviseddl_tpu_torch.masks.densecrf import densecrf_inference
from weaklysuperviseddl_tpu_torch.ops.bilateral import gaussian_filter_rff, rff_basis

pytestmark = pytest.mark.usefixtures("single_torch_thread")

# the reference's CRF parameters (AlternatingDirectionCutLoss.py:183-204)
REFERENCE = dict(gauss_sxy=1.0, gauss_compat=2.0, bilat_sxy=50.0, bilat_srgb=5.0,
                 bilat_compat=10.0, n_iters=5)


def jax_draws(d: int, dim: int):
    """W [d,dim] and b [dim] as JAX's ``rff_basis`` draws them."""
    kw, kb = jax.random.split(jax.random.PRNGKey(7))
    return (np.array(jax.random.normal(kw, (d, dim), jnp.float32)),
            np.array(jax.random.uniform(kb, (dim,), jnp.float32, 0.0, 2.0 * np.pi)))


def _crf_pair(probs, images, jax_backend=None, **kw):
    want = np.asarray(jax_densecrf(jnp.asarray(probs), jnp.asarray(images),
                                   **{**kw, "bilat_backend": jax_backend or kw["bilat_backend"]}))
    got = densecrf_inference(torch.from_numpy(probs), torch.from_numpy(images), **kw).numpy()
    return got, want


def _assert_crf_close(got, want):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_grid_matches_jax_on_make_case():
    """24², two images of test_densecrf.make_case at its parameters."""
    cases = [make_case(seed) for seed in (0, 1)]
    probs = np.stack([c[2] for c in cases]).astype(np.float32)
    images = np.stack([c[0] for c in cases]).astype(np.float32)
    _assert_crf_close(*_crf_pair(probs, images, bilat_backend="grid", **PARAMS))


@pytest.fixture(scope="module")
def pets_72():
    """Two 72² synthetic pets with noisy trimap CAMs, and the port's grid
    marginals at the reference's parameters."""
    images, _, trimaps = synthetic_pet_arrays(2, image_size=72, seed=3)
    images = (images * 255).astype(np.float32)
    rng = np.random.default_rng(3)
    cam = np.clip((trimaps == 1) * 0.6 + rng.uniform(-0.3, 0.3, (2, 72, 72)), 0, 1)
    probs = np.clip(np.stack([1 - cam, cam], -1), 1e-8, 1.0).astype(np.float32)
    with torch.no_grad():
        got = densecrf_inference(torch.from_numpy(probs), torch.from_numpy(images),
                                 bilat_backend="grid", **REFERENCE).numpy()
    return probs, images, got


@pytest.mark.parametrize("jax_backend", ["grid", "attention"])
def test_grid_matches_jax_at_72(pets_72, jax_backend):
    """At 72² the reference's parameters give a grid of 4x4x54³ cells; JAX's
    "attention" computes the same grid there."""
    probs, images, got = pets_72
    want = np.asarray(jax_densecrf(jnp.asarray(probs), jnp.asarray(images),
                                   bilat_backend=jax_backend, **REFERENCE))
    _assert_crf_close(got, want)
    assert 0.05 < got.argmax(-1).mean() < 0.95  # the masks have structure


def _bf16_ulp(x):
    """The spacing of bfloat16 at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("scale", [2.0, 51.0])
def test_rff_basis_with_jax_draws(scale):
    """Φ within one bfloat16 ulp of JAX's Φ, plus what two float32 ulps of
    the projection move the cosine (near its zeros the ulp of Φ is far
    smaller than that): the two packages sum the projection's 5 products in
    other orders. Feature ranges of the working regime and of the reference's
    (colours / 5 reach 51)."""
    rng = np.random.default_rng(3)
    feats = rng.uniform(0, scale, (600, 5)).astype(np.float32)
    draws = jax_draws(5, 4096)
    want = np.asarray(jax_rff_basis(jnp.asarray(feats), dim=4096).astype(jnp.float32))
    got = rff_basis(torch.from_numpy(feats), 4096, draws=draws)
    assert got.dtype == torch.bfloat16 and got.shape == (600, 4096)
    got = got.float().numpy()
    # a float32 ulp of the largest partial sum of the projection, twice
    mag = np.abs(feats.astype(np.float64)) @ np.abs(draws[0]).astype(np.float64) + draws[1]
    phase = np.sqrt(2.0 / 4096) * 2 * np.spacing(mag.astype(np.float32))
    diff = np.abs(got.astype(np.float64) - want)
    assert np.all(diff <= _bf16_ulp(np.maximum(np.abs(got), np.abs(want))) + phase)
    assert (got == want).mean() > 0.99


def test_rff_filter_matches_jax():
    """The same Φ (JAX's) on both sides: rtol 1e-5."""
    rng = np.random.default_rng(4)
    feats = rng.uniform(0, 2.0, (600, 5)).astype(np.float32)
    v = rng.uniform(0, 1, (600, 2)).astype(np.float32)
    phi = jax_rff_basis(jnp.asarray(feats), dim=4096)
    want = np.asarray(jax_filter_rff(phi, jnp.asarray(v)))
    phi_t = torch.from_numpy(np.array(phi.astype(jnp.float32))).bfloat16()
    got = gaussian_filter_rff(phi_t, torch.from_numpy(v))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    # Φ held as float32 gives the same bits
    torch.testing.assert_close(gaussian_filter_rff(phi_t.float(), torch.from_numpy(v)), got,
                               rtol=0, atol=0)


def test_rff_filter_accurate_only_at_narrow_feature_range():
    """JAX's two-sided regime test (test_densecrf.py) on the port with its
    own draws: accurate where the features span a few σ, a measured negative
    result at the reference's bandwidths (±51σ)."""
    rng = np.random.default_rng(3)
    N = 600

    def golden_and_est(scale, dim):
        feats = rng.uniform(0, scale, (N, 5))
        v = rng.uniform(0, 1, (N, 2))
        d2 = ((feats[:, None, :] - feats[None, :, :]) ** 2).sum(-1)
        gold = np.exp(-0.5 * d2) @ v
        phi = rff_basis(torch.from_numpy(feats.astype(np.float32)), dim=dim)
        est = gaussian_filter_rff(phi, torch.from_numpy(v.astype(np.float32))).numpy()
        return np.abs(est - gold).max() / np.abs(gold).max()

    assert golden_and_est(scale=2.0, dim=4096) < 0.1
    assert golden_and_est(scale=51.0, dim=4096) > 0.3


def test_rff_draws_are_seeded_and_checked():
    feats = torch.from_numpy(np.random.default_rng(0).uniform(0, 2, (20, 5)).astype(np.float32))
    torch.testing.assert_close(rff_basis(feats, 64), rff_basis(feats, 64), rtol=0, atol=0)
    other = rff_basis(feats, 64, generator=torch.Generator().manual_seed(8))
    assert not torch.equal(other, rff_basis(feats, 64))
    with pytest.raises(ValueError, match="do not fit"):
        rff_basis(feats, 64, draws=jax_draws(5, 32))


def test_rff_crf_matches_jax_with_jax_draws(monkeypatch):
    """JAX's end-to-end RFF case (16², D 512, test_densecrf.py) and the 24²
    make_case pair at D 4096, JAX's draws on both sides."""
    for probs, images, dim in (
            (make_case(2, H=16, W=16)[2][None], make_case(2, H=16, W=16)[0][None], 512),
            (np.stack([make_case(s)[2] for s in (0, 1)]),
             np.stack([make_case(s)[0] for s in (0, 1)]), 4096)):
        monkeypatch.setattr(densecrf, "rff_basis",
                            functools.partial(rff_basis, draws=jax_draws(5, dim)))
        got, want = _crf_pair(probs.astype(np.float32), images.astype(np.float32),
                              bilat_backend="rff", rff_dim=dim, **PARAMS)
        _assert_crf_close(got, want)
        np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


