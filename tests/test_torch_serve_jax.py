"""Served masks against the JAX package's Predictor at two input sizes (moved
out of test_torch_serve.py so that xdist starts these heavy cases after the
long JAX files)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_serve import SIZE, _requests, centred_pair

from weaklysuperviseddl_tpu.data.preprocess import preprocess_batch as jax_preprocess
from weaklysuperviseddl_tpu.masks.components import keep_largest_batch as jax_keep_largest
from weaklysuperviseddl_tpu.pipelines.serve import Predictor as JaxPredictor
from weaklysuperviseddl_tpu.train.segmentation import _normalize_images as jax_normalize
from weaklysuperviseddl_tpu_torch.masks.components import keep_largest_batch
from weaklysuperviseddl_tpu_torch.pipelines.serve import Predictor


@pytest.mark.parametrize("hw", [(40, 56), (64, 64)], ids=["up-down", "down-aa"])
def test_served_masks_match_jax(hw):
    imgs = _requests(0, 5, hw)
    model, variables, port = centred_pair(imgs)
    state = types.SimpleNamespace(params=jax.tree.map(jnp.asarray, variables["params"]),
                                  batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]))
    jpred = JaxPredictor(model, state, size=SIZE, max_batch=4, clean=True, packed=True)
    tpred = Predictor(port, size=SIZE, max_batch=4, clean=True, packed=True, device="cpu")
    ragged = [imgs[:3], imgs[3:4], imgs[4:]]  # buckets 4, 1, 1
    want = np.concatenate([jpred(r) for r in ragged])
    got = np.concatenate([tpred(r) for r in ragged])
    assert got.shape == (5, SIZE, SIZE) and got.dtype == np.uint8
    assert 0.1 < want.mean() < 0.9  # masks with structure, not one class

    # the JAX logits margin: where the two classes are further apart than
    # float32 differences between two frameworks can move them, masks agree
    x, _ = jax_preprocess(jnp.asarray(imgs), None, size=SIZE)
    logits = np.asarray(model.apply(variables, jax_normalize(x), train=False))
    margin = np.abs(logits[..., 1] - logits[..., 0])
    clear = margin > 1e-3
    np.testing.assert_array_equal(got[clear], want[clear])
    assert (got == want).mean() >= 0.999

    # keep-largest alone is exact: the port's on JAX's own argmax
    jax_argmax = logits.argmax(-1).astype(np.uint8)
    np.testing.assert_array_equal(
        keep_largest_batch(torch.from_numpy(jax_argmax)).numpy(),
        np.asarray(jax_keep_largest(jnp.asarray(jax_argmax))))

