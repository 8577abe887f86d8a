"""The port's host goldens (``native/wsdl_native.cpp``, a copy of the JAX
package's source, built by the port into its own ``build/``) against the JAX
package's bindings on the same numpy inputs, and the port's own CRF backends
and plain connected components against those goldens at the sizes and
tolerances of ``tests/test_densecrf.py``.

The port builds without ``-march=native`` (the JAX package's ``build.sh``
uses it), so the float goldens may differ from JAX's library in the last
bits: the mean-field marginals within 1e-5, the raw lattice filter within
1e-5 of its largest output. Labels are equal."""

import numpy as np
import pytest
import torch
from scipy import ndimage
from test_densecrf import PARAMS, make_case
from test_torch_refine import single_torch_thread  # noqa: F401  (fixture)

from weaklysuperviseddl_tpu import native as jax_native
from weaklysuperviseddl_tpu_torch import native
from weaklysuperviseddl_tpu_torch.masks import synthetic
from weaklysuperviseddl_tpu_torch.masks.components import keep_largest_batch, label_components
from weaklysuperviseddl_tpu_torch.masks.densecrf import densecrf_inference
from weaklysuperviseddl_tpu_torch.masks.permutohedral import (
    permutohedral_filter,
    permutohedral_precompute,
)
from weaklysuperviseddl_tpu_torch.ops.build import BUILD_DIR

pytestmark = pytest.mark.usefixtures("single_torch_thread")

ALPHA_5D = 1.0 / (1.0 + 2.0 ** -5)  # the golden lattice's scale, wsdl_native.cpp:228


def _field_mask(seed: int, shape, sigma: float, keep: float) -> np.ndarray:
    field = ndimage.gaussian_filter(np.random.default_rng(seed).standard_normal(shape), sigma)
    return (field > np.quantile(field, 1 - keep)).astype(np.uint8)


MASKS = {
    "make_case": lambda: (make_case(2, noise=0.45)[1] > 0.5).astype(np.uint8),
    "field_40": lambda: _field_mask(3, (40, 40), 3.0, 0.4),
    "field_32": lambda: _field_mask(4, (32, 32), 2.5, 0.35),
    "field_odd": lambda: _field_mask(5, (23, 57), 1.5, 0.5),
    "speckle": lambda: synthetic.family("speckle", 1, (31, 29), seed=6)[0],
    "empty": lambda: np.zeros((8, 8), np.uint8),
}


def _lattice_features(H: int, W: int, sxy: float, srgb: float, seed: int):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, (H, W, 3)).astype(np.float32)
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    feats = np.stack([x / sxy, y / sxy, img[..., 0] / srgb,
                      img[..., 1] / srgb, img[..., 2] / srgb], -1).reshape(-1, 5)
    return feats, rng.uniform(size=(H * W, 2)).astype(np.float32)


def _port_crf(probs: np.ndarray, img: np.ndarray, backend: str) -> np.ndarray:
    return densecrf_inference(torch.from_numpy(probs)[None],
                              torch.from_numpy(img.astype(np.float32))[None],
                              bilat_backend=backend, **PARAMS)[0].numpy()


# ---- the build ----------------------------------------------------------------------------


def test_goldens_build_from_the_port_into_its_build_dir():
    path = native.goldens_library_path()
    assert path.parent == BUILD_DIR and path.name.startswith("libwsdl_native-")
    assert native._GOLDENS.source.parent == BUILD_DIR.parent / "native"
    native.load_goldens()
    assert path.exists()


def test_failed_build_raises_and_keeps_its_error(tmp_path, monkeypatch):
    """A build that g++ refuses raises with g++'s output, and a second load
    raises the same error without running the compiler again."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    lib = native._Library("wsdl_native.cpp", ("--no-such-option",), {})
    with pytest.raises(RuntimeError, match="no-such-option") as first:
        lib.load()
    calls = []
    monkeypatch.setattr(native.subprocess, "run", lambda *a, **k: calls.append(a))
    with pytest.raises(RuntimeError) as second:
        lib.load()
    assert second.value is first.value and not calls
    assert not list(tmp_path.glob("*.so"))


# ---- the port's bindings against JAX's ---------------------------------------------------


@pytest.mark.parametrize("case", sorted(MASKS))
def test_components_equal_jax_bindings(case):
    mask = MASKS[case]()
    labels = native.label_components(mask)
    assert labels.dtype == np.int32 and labels.shape == mask.shape
    np.testing.assert_array_equal(labels, jax_native.label_components(mask))
    kept = native.keep_largest(mask)
    assert kept.dtype == np.uint8
    np.testing.assert_array_equal(kept, jax_native.keep_largest(mask))
    if case == "empty":
        np.testing.assert_array_equal(kept, mask)
        assert (labels == -1).all()


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "lattice"])
def test_densecrf_matches_jax_bindings(exact):
    img, _, _, unary = make_case(1)
    got = native.densecrf(unary, img, exact=exact, **PARAMS)
    want = jax_native.densecrf(unary, img, exact=exact, **PARAMS)
    assert got.shape == want.shape == (24, 24, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


def test_permutohedral_filter_matches_jax_bindings():
    feats, vals = _lattice_features(20, 22, 6.0, 20.0, seed=7)
    got = native.permutohedral_filter(feats, vals)
    want = jax_native.permutohedral_filter(feats, vals)
    assert got.shape == (440, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


# ---- the port's paths against the goldens ------------------------------------------------


def test_attention_crf_matches_exact_golden():
    """The exact filter is the golden's O(N²) sum: float-level tolerance, as
    ``test_jax_attention_matches_brute_force``."""
    img, _, probs, unary = make_case(1)
    q_exact = native.densecrf(unary, img, exact=True, **PARAMS)
    q = _port_crf(probs, img, "attention")
    assert np.abs(q_exact - q).mean() < 1e-4
    assert (q_exact.argmax(-1) == q.argmax(-1)).mean() == 1.0


@pytest.mark.parametrize("backend", ["grid", "lattice"])
def test_approximate_crf_matches_exact_golden(backend):
    img, _, probs, unary = make_case(1)
    q_exact = native.densecrf(unary, img, exact=True, **PARAMS)
    q = _port_crf(probs, img, backend)
    assert np.abs(q_exact - q).mean() < 0.05
    assert (q_exact.argmax(-1) == q.argmax(-1)).mean() > 0.97


def test_lattice_filter_matches_golden_lattice():
    """The port's lattice is the golden's construction: the raw filter within
    1e-3 relative once the golden's constant α is applied."""
    feats, vals = _lattice_features(20, 22, 6.0, 20.0, seed=7)
    cpp = native.permutohedral_filter(feats, vals)
    mine = permutohedral_filter(torch.from_numpy(vals),
                                permutohedral_precompute(torch.from_numpy(feats))).numpy()
    rel = (np.abs(mine * ALPHA_5D - cpp) / np.abs(cpp).clip(1e-9)).mean()
    assert rel < 1e-3, rel


@pytest.mark.parametrize("family", synthetic.FAMILIES)
@pytest.mark.parametrize("shape", [(40, 48), (37, 23)], ids=["40x48", "37x23"])
def test_plain_components_equal_union_find(family, shape):
    """The plain labelling and keep-largest (K2's twin, the CPU path) against
    the union-find, image by image, on every family: speckle, the snake and
    the spiral included."""
    masks = synthetic.family(family, 4, shape, seed=11)
    labels = label_components(torch.from_numpy(masks)).numpy()
    kept = keep_largest_batch(torch.from_numpy(masks)).numpy()
    for i, m in enumerate(masks):
        np.testing.assert_array_equal(labels[i], native.label_components(m), err_msg=str(i))
        np.testing.assert_array_equal(kept[i], native.keep_largest(m), err_msg=str(i))
