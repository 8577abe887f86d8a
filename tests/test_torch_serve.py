"""The port's serving slice end to end against the JAX package: the same
weights (carried across by models/jax_import.py) and the same uint8 requests
through JAX ``Predictor(clean=True, packed=True)`` and the port's
``Predictor(device="cpu", clean=True, packed=True)``. The served masks
against JAX's are in ``test_torch_serve_jax.py``."""


import numpy as np
import pytest
import torch
from test_torch_models import jax_deeplab_numpy, port_from_jax

from weaklysuperviseddl_tpu_torch.data.preprocess import normalize_images, preprocess_images
from weaklysuperviseddl_tpu_torch.pipelines.serve import Predictor, pack_binary_masks

SIZE = 48


def _requests(seed, n, hw):
    return (np.random.default_rng(seed).uniform(0, 1, (n, *hw, 3)) * 255).astype(np.uint8)


def centred_pair(images):
    """(JAX model, JAX variables, port model): depth 18, width 0.25. Random
    weights put nearly every pixel in one class, so the class-1 bias is moved
    by the median logit margin on ``images``: masks then split about evenly
    into a few components, and cleanup has work to do."""
    model, variables = jax_deeplab_numpy(18, 0.25, seed=1, size=SIZE)
    port = port_from_jax(variables, 18, 0.25)
    x = torch.from_numpy(images).permute(0, 3, 1, 2)
    with torch.no_grad():
        logits = port(normalize_images(preprocess_images(x, SIZE), channel_dim=1))
    params = dict(variables["params"])
    bias = params["classifier"]["bias"].copy()
    bias[1] -= float((logits[:, 1] - logits[:, 0]).median())
    params["classifier"] = {**params["classifier"], "bias": bias}
    variables = {"params": params, "batch_stats": variables["batch_stats"]}
    return model, variables, port_from_jax(variables, 18, 0.25)


@pytest.fixture(scope="module")
def pair():
    return centred_pair(_requests(99, 4, (SIZE, SIZE)))


def test_predictor_bucket_padding(pair):
    """Ragged requests pad to the next pow-2 bucket, not to max_batch."""
    port = pair[2]
    pred = Predictor(port, size=SIZE, max_batch=8, device="cpu")
    assert [pred._bucket(n) for n in (1, 2, 3, 5, 8)] == [1, 2, 4, 8, 8]
    assert pred.buckets() == [1, 2, 4, 8]

    dispatched = []
    orig = pred._dispatch

    def spy(images, did):
        dispatched.append(tuple(images.shape))
        return orig(images, did)

    pred._dispatch = spy
    imgs = _requests(2, 5, (SIZE, SIZE))
    full = pred(imgs)
    ragged = np.concatenate([pred(imgs[:3]), pred(imgs[3:])])
    np.testing.assert_array_equal(full, ragged)
    assert [s[0] for s in dispatched] == [8, 4, 2]  # 5→8, 3→4, 2→2
    assert all(s[1:] == (SIZE, SIZE, 3) for s in dispatched)

    # non-pow2 max_batch: the top bucket is max_batch itself
    pred6 = Predictor(port, size=SIZE, max_batch=6, device="cpu")
    assert [pred6._bucket(n) for n in (4, 5, 6)] == [4, 6, 6]
    assert pred6.buckets() == [1, 2, 4, 6]
    with pytest.raises(ValueError, match="exceeds max_batch"):
        pred6(_requests(3, 7, (8, 8)))


def test_packed_and_pipelined_match_per_call(pair):
    """pack_binary_masks round-trips through np.unpackbits, and the packed and
    pipelined (predict_many) paths give exactly the per-call masks, ragged
    tail chunk included."""
    rng = np.random.default_rng(0)
    m = rng.integers(0, 2, (2, 5, 16)).astype(np.uint8)
    packed = pack_binary_masks(torch.from_numpy(m)).numpy()
    assert packed.shape == (2, 5, 2) and packed.dtype == np.uint8
    np.testing.assert_array_equal(np.unpackbits(packed, axis=-1), m)

    port = pair[2]
    imgs = _requests(4, 11, (SIZE, SIZE))
    plain = Predictor(port, size=SIZE, max_batch=4, device="cpu")
    ref = np.concatenate([plain(imgs[s : s + 4]) for s in range(0, 11, 4)])
    for packed_flag in (False, True):
        p = Predictor(port, size=SIZE, max_batch=4, packed=packed_flag, device="cpu")
        got = p.predict_many(imgs, in_flight=2)  # 2 full chunks + a tail of 3
        assert got.shape == (11, SIZE, SIZE)
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(p(imgs[:3]), ref[:3])


def test_packed_needs_two_classes():
    from weaklysuperviseddl_tpu_torch.models.deeplabv3 import DeepLabV3

    with pytest.raises(ValueError, match="BINARY"):
        Predictor(DeepLabV3(3, 18, 0.25), size=SIZE, packed=True, device="cpu")


def test_warmup_runs_every_bucket(pair):
    pred = Predictor(pair[2], size=SIZE, max_batch=4, device="cpu")
    seen = []
    orig = pred._dispatch
    pred._dispatch = lambda images, did: seen.append(images.shape[0]) or orig(images, did)
    assert pred.warmup((32, 40), all_buckets=True) is pred
    assert seen == [1, 2, 4]
