"""Port parity: resizing and preprocessing (weaklysuperviseddl_tpu_torch.ops.resize,
.data.preprocess) against the JAX package on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weaklysuperviseddl_tpu.data.preprocess import preprocess_batch as jax_preprocess
from weaklysuperviseddl_tpu.ops import resize as jax_resize
from weaklysuperviseddl_tpu_torch.data.preprocess import preprocess_batch
from weaklysuperviseddl_tpu_torch.ops import resize
from weaklysuperviseddl_tpu_torch.train.segmentation import _normalize_images

# float32 resampling in two frameworks: the same taps summed in another order
ATOL = 1e-6


def _images(seed, shape):
    return (np.random.default_rng(seed).uniform(0, 1, shape) * 255).astype(np.uint8)


@pytest.mark.parametrize("in_hw", [(48, 48), (80, 60), (64, 64), (50, 90)],
                         ids=["up", "down-aa", "same", "mixed"])
@pytest.mark.parametrize("normalize", [False, True])
def test_preprocess_batch_matches_jax(in_hw, normalize):
    imgs = _images(0, (2, *in_hw, 3))
    trimaps = np.random.default_rng(1).integers(1, 4, (2, *in_hw)).astype(np.uint8)
    want_x, want_t = jax_preprocess(jnp.asarray(imgs), jnp.asarray(trimaps), size=64,
                                    normalize=normalize)
    got_x, got_t = preprocess_batch(torch.from_numpy(imgs), torch.from_numpy(trimaps),
                                    size=64, normalize=normalize)
    assert got_x.shape == (2, 64, 64, 3) and got_x.dtype == torch.float32
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))


@pytest.mark.parametrize("flags", [dict(shift_mask_labels=False),
                                   dict(shift_mask_labels=True, binarize_fg=True)])
def test_preprocess_trimap_options_match_jax(flags):
    imgs = _images(2, (2, 37, 53, 3))
    trimaps = np.random.default_rng(3).integers(1, 4, (2, 37, 53)).astype(np.uint8)
    _, want = jax_preprocess(jnp.asarray(imgs), jnp.asarray(trimaps), size=32, **flags)
    _, got = preprocess_batch(torch.from_numpy(imgs), torch.from_numpy(trimaps), size=32,
                              **flags)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_preprocess_bicubic_matches_jax():
    imgs = _images(4, (2, 70, 50, 3))
    want, _ = jax_preprocess(jnp.asarray(imgs), None, size=64, interpolation="bicubic")
    got, _ = preprocess_batch(torch.from_numpy(imgs), None, size=64, interpolation="bicubic")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("fn,kw", [
    ("resize_bilinear", dict(antialias=False)),
    ("resize_bilinear", dict(antialias=True)),
    ("resize_bicubic", dict(antialias=True)),
    ("resize_bicubic", dict(antialias=False)),
])
@pytest.mark.parametrize("out_hw", [(24, 40), (61, 31)], ids=["down", "up-down"])
def test_resize_matches_jax(fn, kw, out_hw):
    x = np.random.default_rng(5).standard_normal((2, 45, 33, 3)).astype(np.float32)
    want = getattr(jax_resize, fn)(jnp.asarray(x), out_hw, **kw)
    got = getattr(resize, fn)(torch.from_numpy(x), out_hw, **kw)
    # unit-variance inputs; cubic overshoot keeps values within a few units
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=4 * ATOL)


@pytest.mark.parametrize("torch_legacy", [True, False])
def test_resize_nearest_matches_jax(torch_legacy):
    x = np.random.default_rng(6).integers(0, 255, (3, 37, 29)).astype(np.uint8)
    for out_hw in [(64, 64), (20, 11), (37, 29)]:
        want = jax_resize.resize_nearest(jnp.asarray(x), out_hw, torch_legacy, axes=(1, 2))
        got = resize.resize_nearest(torch.from_numpy(x), out_hw, torch_legacy, axes=(1, 2))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_normalize_images_matches_jax():
    from weaklysuperviseddl_tpu.train.segmentation import _normalize_images as jax_norm

    x = np.random.default_rng(7).uniform(0, 1, (2, 5, 6, 3)).astype(np.float32)
    np.testing.assert_allclose(_normalize_images(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_norm(jnp.asarray(x))), atol=ATOL)
