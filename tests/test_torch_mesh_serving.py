"""Data-parallel serving: Predictor(mesh=) on CPU devices against the one-
device Predictor, bit for bit, and its buckets and checks (moved out of
test_torch_mesh.py so that xdist starts these heavy tests after the long JAX
files)."""

import numpy as np
import pytest
import torch

from weaklysuperviseddl_tpu_torch.models.deeplabv3 import DeepLabV3
from weaklysuperviseddl_tpu_torch.models.resnet import init_weights
from weaklysuperviseddl_tpu_torch.parallel.mesh import make_mesh
from weaklysuperviseddl_tpu_torch.pipelines.serve import Predictor


@pytest.fixture(scope="module")
def serving():
    model = init_weights(DeepLabV3(2, 18, 0.25), torch.Generator().manual_seed(0))
    imgs = (np.random.default_rng(2).uniform(0, 1, (8, 48, 48, 3)) * 255).astype(np.uint8)
    return model, imgs, Predictor(model, size=48, max_batch=8, device="cpu")(imgs)


@pytest.mark.parametrize("variant", ["float32", "packed", "int8"])
def test_data_parallel_serving_matches_one_device_bit_for_bit(serving, variant):
    """JAX's tests/test_pipelines.py: Predictor(mesh=) on a data axis of 8
    gives the one-device Predictor's masks exactly, float32, packed and int8
    (each quantized once on the same images)."""
    model, imgs, ref = serving
    mesh = make_mesh(data=8, devices=[torch.device("cpu")] * 8)
    dp = Predictor(model, size=48, max_batch=8, mesh=mesh, packed=variant == "packed")
    if variant == "int8":
        dp.quantize(imgs)
        one = Predictor(model, size=48, max_batch=8, device="cpu")
        one.quantize(imgs)
        ref = one(imgs)
        np.testing.assert_array_equal(dp(imgs[:3]), one(imgs[:3]))
    np.testing.assert_array_equal(dp(imgs), ref)


def test_data_parallel_serving_buckets_and_checks():
    model = DeepLabV3(2, 18, 0.25)
    mesh = make_mesh(data=4, model=2, devices=[torch.device("cpu")] * 8)
    pred = Predictor(model, size=32, max_batch=8, mesh=mesh)
    assert [pred._bucket(n) for n in (1, 3, 5, 8)] == [4, 4, 8, 8]
    assert pred.buckets() == [4, 8]
    with pytest.raises(ValueError, match="max_batch 6 not divisible by data axis 4"):
        Predictor(model, size=32, max_batch=6, mesh=mesh)
    with pytest.raises(ValueError, match="not both"):
        Predictor(model, size=32, max_batch=8, mesh=mesh, device="cpu")

