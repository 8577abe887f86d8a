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


def _refine_case(seed, B, H, W, C, cuda):
    rng = np.random.default_rng(seed)
    S = rng.uniform(0.1, 1, (B, H, W, C)).astype(np.float32)
    S /= S.sum(-1, keepdims=True)
    images = rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32)
    masks = rng.integers(0, C, (B, H, W)).astype(np.int32)
    return tuple(torch.from_numpy(a).to(cuda) for a in (S, images, masks))


@pytest.mark.parametrize("lr", [1e-2, 0.2])
@pytest.mark.parametrize("window", [3, 5])
@pytest.mark.parametrize("C", [2, 3])
@pytest.mark.parametrize("loss", ["ncut", "boundary"])
@pytest.mark.parametrize("shape", [(2, 16, 16), (1, 20, 24), (2, 37, 53)])
def test_refine_kernel_equals_plain(cuda, shape, loss, C, window, lr):
    """Masks equal and loss within 1e-4 (the tolerance the JAX package holds
    its Pallas kernel to against XLA); two launches give the same bits. At lr
    1e-2 no pixel can cross the threshold in 8 steps; at 0.2 many do."""
    from weaklysuperviseddl_tpu_torch.ops.refine import refine_cuda, refine_plain

    S, images, masks = _refine_case(0, *shape, C, cuda)
    kw = dict(num_steps=8, lr=lr, loss=loss, window_size=window)
    want_m, want_l = refine_plain(S, images, masks, **kw)
    got_m, got_l = refine_cuda(S, images, masks, **kw)
    again_m, again_l = refine_cuda(S, images, masks, **kw)
    torch.cuda.synchronize()
    assert got_m.dtype == torch.uint8 and got_m.shape == shape
    if lr > 0.1:
        assert (got_m != (masks == 1)).float().mean().item() > 0.05
    assert torch.equal(got_m, want_m)
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-4)
    assert torch.equal(again_m, got_m) and float(again_l) == float(got_l)


@pytest.mark.parametrize("lr", [1e-2, 0.1])
def test_refine_kernel_path_shape(cuda, lr):
    """[4,256,256], C=2, 20 steps: near-threshold pixels may flip, because the
    fp32 sums are taken in another order."""
    from weaklysuperviseddl_tpu_torch.ops.refine import refine_cuda, refine_plain

    S, images, masks = _refine_case(1, 4, 256, 256, 2, cuda)
    want_m, want_l = refine_plain(S, images, masks, lr=lr)
    got_m, got_l = refine_cuda(S, images, masks, lr=lr)
    torch.cuda.synchronize()
    if lr > 0.05:
        assert (got_m != masks).float().mean().item() > 0.05
    assert (got_m == want_m).float().mean().item() >= 0.9999
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-4)


def test_refine_wrapper_routes_and_checks(cuda):
    from weaklysuperviseddl_tpu_torch.ops.refine import refine_cuda
    from weaklysuperviseddl_tpu_torch.train.refine import refine_from_soft_predictions

    S, images, masks = _refine_case(2, 1, 16, 16, 2, cuda)
    before = refine_cuda.launches
    refine_from_soft_predictions(S, images, masks, num_steps=2)
    assert refine_cuda.launches == before + 1
    refine_from_soft_predictions(S, images, masks, num_steps=2, use_pallas=False)
    assert refine_cuda.launches == before + 1
    with pytest.raises(TypeError):
        refine_cuda(S.double(), images, masks)
    with pytest.raises(ValueError):
        refine_cuda(S, images, masks, window_size=9)
    with pytest.raises(ValueError):
        refine_cuda(S[:, :, ::2].contiguous(), images, masks)
    with pytest.raises(ValueError):
        refine_cuda(S.permute(0, 2, 1, 3), images, masks)


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
