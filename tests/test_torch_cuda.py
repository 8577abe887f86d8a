"""The port on the card: the CUDA connected-components kernel against its plain
version, and the serving path on CUDA against the CPU. Needs an NVIDIA GPU and
nvcc; skipped elsewhere. Imports no JAX, so it runs where JAX is absent:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from weaklysuperviseddl_tpu_torch.masks import synthetic
from weaklysuperviseddl_tpu_torch.masks.components import keep_largest_batch, label_components
from weaklysuperviseddl_tpu_torch.ops.cc import label_components_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(4, 70, 99), (2, 256, 256), (3, 31, 33)])
@pytest.mark.parametrize("name", synthetic.FAMILIES)
def test_kernel_labels_equal_plain(cuda, name, shape):
    masks = torch.from_numpy(synthetic.family(name, shape[0], shape[1:], seed=3))
    want = label_components(masks)
    got = label_components_cuda(masks.to(cuda))
    again = label_components_cuda(masks.to(cuda))
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == masks.shape
    assert torch.equal(got.cpu(), want)
    assert torch.equal(again, got)  # atomics in any order, the same labels


def test_keep_largest_auto_launches_the_kernel(cuda):
    masks = torch.from_numpy(synthetic.family("blobs", 5, (64, 80)))
    before = label_components_cuda.launches
    got = keep_largest_batch(masks.to(cuda))
    assert label_components_cuda.launches == before + 1
    assert torch.equal(got.cpu(), keep_largest_batch(masks, backend="plain"))


def test_kernel_wrapper_checks_its_input(cuda):
    with pytest.raises(TypeError):
        label_components_cuda(torch.zeros((1, 8, 8), dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):
        label_components_cuda(torch.zeros((8, 8), dtype=torch.uint8, device=cuda))
    with pytest.raises(ValueError):
        label_components_cuda(torch.zeros((1, 8, 16), dtype=torch.uint8, device=cuda)[..., ::2])
    assert label_components_cuda(torch.zeros((0, 8, 8), dtype=torch.uint8, device=cuda)).shape == (0, 8, 8)


def test_predictor_on_card_matches_cpu(cuda):
    from weaklysuperviseddl_tpu_torch.models.deeplabv3 import DeepLabV3
    from weaklysuperviseddl_tpu_torch.models.resnet import init_weights
    from weaklysuperviseddl_tpu_torch.pipelines.serve import Predictor

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = init_weights(DeepLabV3(2, 18, 0.25), torch.Generator().manual_seed(0))
    imgs = (np.random.default_rng(0).uniform(0, 1, (3, 50, 70, 3)) * 255).astype(np.uint8)
    cpu = Predictor(model, size=64, max_batch=4, clean=True, packed=True, device="cpu")(imgs)
    gpu = Predictor(model, size=64, max_batch=4, clean=True, packed=True, device=cuda)(imgs)
    # float32 on both, convolutions summed in another order: near-tie pixels may flip
    assert (gpu == cpu).mean() >= 0.995
