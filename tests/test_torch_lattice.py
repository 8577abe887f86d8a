"""Port parity for the permutohedral lattice (``masks/permutohedral.py``) and
the CRF's "lattice" backend, against the JAX package on the same numpy
inputs.

The geometry (entries, weights, runs, blur neighbours) is bit-equal to that
of JAX's function run op by op (under ``jax.jit`` XLA contracts some of the
weights' products into FMAs, which moves them by up to 1e-6).
The filter sums each vertex's entries as a difference of a float64 cumulative
sum; JAX's float32 cumulative sum is a sequential window on the CPU, which at
20x22 (M = 2,640 entries) is up to 2e-3 off the exact sums. So the port's
filter is held at rtol 1e-5 to JAX's own filter run in float64 on the same
float32 geometry, and to JAX's float32 filter within JAX's own distance from
that."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_densecrf import PARAMS, make_case
from test_torch_refine import single_torch_thread  # noqa: F401  (fixture)

from weaklysuperviseddl_tpu.masks.densecrf import densecrf_inference as jax_densecrf
from weaklysuperviseddl_tpu.masks.permutohedral import coordinate_bound as jax_coordinate_bound
from weaklysuperviseddl_tpu.masks.permutohedral import permutohedral_filter as jax_filter
from weaklysuperviseddl_tpu.masks.permutohedral import (
    permutohedral_precompute as jax_precompute,
)
from weaklysuperviseddl_tpu_torch.data.synthetic import synthetic_pet_arrays
from weaklysuperviseddl_tpu_torch.masks.densecrf import densecrf_inference
from weaklysuperviseddl_tpu_torch.masks.permutohedral import (
    _COORD_MAX,
    coordinate_bound,
    permutohedral_filter,
    permutohedral_precompute,
)

pytestmark = pytest.mark.usefixtures("single_torch_thread")

# the reference's CRF parameters (AlternatingDirectionCutLoss.py:183-204)
REFERENCE = dict(gauss_sxy=1.0, gauss_compat=2.0, bilat_sxy=50.0, bilat_srgb=5.0,
                 bilat_compat=10.0, n_iters=5)
GEOMETRY = ("pix_sorted", "wt_sorted", "start_idx", "end_plus", "vslot", "wt")


def _features(H, W, sxy, srgb, seed):
    """test_densecrf.py's lattice case: random colours, [x, y, r, g, b] / σ."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, (H, W, 3)).astype(np.float32)
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    feats = np.stack([x / sxy, y / sxy] + [img[..., c] / srgb for c in range(3)], -1)
    vals = rng.uniform(size=(H * W, 2)).astype(np.float32)
    return feats.reshape(-1, 5), vals


@pytest.fixture(scope="module")
def lattice_20x22():
    """JAX's geometry and filter at 20x22 (σ 6 / 20), in float32 and, on the
    same float32 geometry, in float64; the inputs as numpy."""
    feats, vals = _features(20, 22, 6.0, 20.0, seed=7)
    pre = jax_precompute(jnp.asarray(feats))
    want32 = np.asarray(jax.jit(lambda v: jax_filter(v, pre))(jnp.asarray(vals)))
    with jax.enable_x64(True):
        pre64 = {k: (jnp.asarray(np.asarray(v)) if hasattr(v, "shape") else v)
                 for k, v in pre.items()}
        want64 = np.asarray(jax.jit(lambda v: jax_filter(v, pre64))(
            jnp.asarray(vals.astype(np.float64))))
    return feats, vals, {k: np.asarray(v) for k, v in pre.items()}, want32, want64


def test_precompute_is_jax_geometry(lattice_20x22):
    """Every entry's pixel, weight and vertex slot, every run's bounds and
    every vertex's blur neighbours equal JAX's, and so the vertex count."""
    feats, _, want, _, _ = lattice_20x22
    got = permutohedral_precompute(torch.from_numpy(feats))
    assert got["M"] == want["vslot"].shape[0] == 20 * 22 * 6
    for name in GEOMETRY:
        np.testing.assert_array_equal(got[name][0].numpy(), want[name], err_msg=name)
    n_vertices = int(got["n_vertices"][0])
    assert n_vertices == int(want["vslot"].max()) + 1
    assert n_vertices < got["M"]  # entries share vertices
    for name in ("blur_n1", "blur_n2"):
        np.testing.assert_array_equal(got[name][:, 0].numpy(), want[name], err_msg=name)


def test_filter_matches_jax(lattice_20x22):
    feats, vals, _, want32, want64 = lattice_20x22
    pre = permutohedral_precompute(torch.from_numpy(feats))
    got = permutohedral_filter(torch.from_numpy(vals), pre).numpy()
    assert got.shape == (440, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, want64, rtol=1e-5, atol=0)
    jax_err = np.abs(want32 - want64) / np.abs(want64)
    assert np.all(np.abs(got - want32) / np.abs(want64) <= jax_err + 1e-5)
    # a batch of two images filters each as alone
    feats2, vals2 = _features(20, 22, 6.0, 20.0, seed=8)
    pre_b = permutohedral_precompute(torch.from_numpy(np.stack([feats, feats2])))
    both = permutohedral_filter(torch.from_numpy(np.stack([vals, vals2])), pre_b)
    np.testing.assert_array_equal(both[0].numpy(), got)
    alone = permutohedral_filter(torch.from_numpy(vals2),
                                 permutohedral_precompute(torch.from_numpy(feats2)))
    np.testing.assert_array_equal(both[1].numpy(), alone.numpy())


@pytest.mark.parametrize("bounds", [
    [221 / 6.0, 199 / 6.0, 255 / 20.0, 255 / 20.0, 255 / 20.0],
    [223 / 50.0, 223 / 50.0, 51.0, 51.0, 51.0],   # the reference at 224²
    [10.0, 10.0],
    [0.0],
    [23 / 50.0, 23 / 50.0, 5100.0, 5100.0, 5100.0],
])
def test_coordinate_bound_equals_jax(bounds):
    assert coordinate_bound(bounds) == jax_coordinate_bound(bounds)


def test_reference_parameters_fit_the_keys_at_224():
    assert coordinate_bound([223 / 50.0, 223 / 50.0] + [255.0 / 5.0] * 3) <= _COORD_MAX


def test_overflow_poisons_the_output_with_nan():
    """JAX's loud failure: keys beyond the packed range NaN-poison the splat
    weights, so the output turns NaN instead of quietly wrong."""
    rng = np.random.default_rng(3)
    ok = rng.uniform(0, 10, (64, 2)).astype(np.float32)
    vals = rng.uniform(0, 1, (64, 2)).astype(np.float32)
    out_ok = permutohedral_filter(torch.from_numpy(vals),
                                  permutohedral_precompute(torch.from_numpy(ok))).numpy()
    assert np.isfinite(out_ok).all()
    bad = permutohedral_precompute(torch.from_numpy(ok * 1e4))
    assert np.isnan(permutohedral_filter(torch.from_numpy(vals), bad).numpy()).any()
    with pytest.raises(ValueError, match="feature dimensions"):
        permutohedral_precompute(torch.zeros((4, 6)))


def test_lattice_crf_rejects_out_of_range_keys():
    probs = torch.full((1, 8, 8, 2), 0.5)
    with pytest.raises(ValueError, match="packed-key range"):
        densecrf_inference(probs, torch.zeros((1, 8, 8, 3)), bilat_srgb=0.05,
                           bilat_backend="lattice")


def _pet_case(n, H, W, seed):
    images, _, trimaps = synthetic_pet_arrays(n, image_size=max(H, W), seed=seed)
    images = (images[:, :H, :W] * 255).astype(np.float32)
    rng = np.random.default_rng(seed)
    cam = (trimaps[:, :H, :W] == 1) * 0.6 + rng.uniform(-0.3, 0.3, (n, H, W))
    cam = np.clip(cam, 0, 1).astype(np.float32)
    return np.clip(np.stack([1 - cam, cam], -1), 1e-8, 1.0).astype(np.float32), images


def _make_case_pair():
    cases = [make_case(seed) for seed in (0, 1)]
    return (np.stack([c[2] for c in cases]).astype(np.float32),
            np.stack([c[0] for c in cases]).astype(np.float32))


@pytest.mark.parametrize("case", ["make_case_24", "pets_48x40_reference"])
def test_densecrf_lattice_matches_jax(case):
    """Marginals within 1e-4 and the argmax equal everywhere: two 24² images
    of test_densecrf.make_case at its parameters, and two 48x40 synthetic
    pets at the reference's."""
    if case == "make_case_24":
        (probs, images), kw = _make_case_pair(), PARAMS
    else:
        (probs, images), kw = _pet_case(2, 48, 40, seed=2), REFERENCE
    want = np.asarray(jax_densecrf(jnp.asarray(probs), jnp.asarray(images),
                                   bilat_backend="lattice", **kw))
    got = densecrf_inference(torch.from_numpy(probs), torch.from_numpy(images),
                             bilat_backend="lattice", **kw).numpy()
    assert got.shape == probs.shape
    assert np.abs(got - want).max() <= 1e-4
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert 0.05 < got.argmax(-1).mean() < 0.95  # the masks have structure
