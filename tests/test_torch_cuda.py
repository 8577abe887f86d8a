"""The port on the card: the CUDA kernels (connected components, refinement
and its plans, the window-loss sum and gradient, the CRF's bilateral filter,
the LayerCAM fusion) against their plain versions, the serving path and
BASNet on CUDA against the CPU. Needs an NVIDIA GPU and nvcc; skipped
elsewhere. Imports no JAX, so it runs where JAX is absent:

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


@pytest.mark.parametrize("shape", [(4, 70, 99), (2, 256, 256), (3, 31, 33), (2, 432, 432),
                                   (2, 434, 434), (1, 1, 9), (1, 9, 1), (2, 224, 48)])
@pytest.mark.parametrize("name", synthetic.FAMILIES)
def test_kernel_labels_equal_plain(cuda, name, shape):
    """Both plans: 432² is the largest square the one-block image plan takes,
    434² goes to the tiles plan (ops/cc.py::plan_for)."""
    from weaklysuperviseddl_tpu_torch.ops.cc import plan_for

    masks = torch.from_numpy(synthetic.family(name, shape[0], shape[1:], seed=3))
    want = label_components(masks)
    plan = plan_for(*shape[1:])
    before = label_components_cuda.plan_launches[plan]
    got = label_components_cuda(masks.to(cuda))
    again = label_components_cuda(masks.to(cuda))
    torch.cuda.synchronize()
    assert label_components_cuda.plan_launches[plan] == before + 2
    assert got.dtype == torch.int32 and got.shape == masks.shape
    assert torch.equal(got.cpu(), want)
    assert torch.equal(again, got)  # atomics in any order, the same labels


@pytest.mark.parametrize("offset", [0, 1])
def test_kernel_label_is_the_smallest_pixel_not_node(cuda, offset):
    """Node 0 holds only pixel (1,0), index 8, but its component's smallest
    pixel is (0,5): the label is 5. offset 1 starts the masks one byte into
    their storage, so the kernel takes its byte-wise path."""
    mask = torch.zeros((2, 4, 16), dtype=torch.uint8)
    for y, x in ((1, 0), (2, 1), (2, 2), (2, 3), (1, 4), (0, 5)):
        mask[:, y, x] = 1
    store = torch.zeros(mask.numel() + offset, dtype=torch.uint8, device=cuda)
    dev = store[offset:].view(mask.shape)
    dev.copy_(mask.to(cuda))
    got = label_components_cuda(dev).cpu()
    assert set(got[mask == 1].tolist()) == {5}
    assert torch.equal(got, label_components(mask))


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


@pytest.mark.parametrize("loss", ["ncut", "boundary"])
@pytest.mark.parametrize("shape,C", [((2, 16, 16), 2), ((1, 20, 24), 2), ((2, 37, 53), 3)])
def test_refine_plans_equal_plain_and_v1(cuda, shape, C, loss):
    """Every plan against plain (masks equal, loss rtol 1e-4); "v2" runs v1's
    kernel and "v2_aff" reads the same affinities from stored planes, so both
    give v1's bits."""
    from weaklysuperviseddl_tpu_torch.ops.refine import refine_cuda, refine_plain

    S, images, masks = _refine_case(3, *shape, C, cuda)
    kw = dict(num_steps=8, lr=0.2, loss=loss)
    want_m, want_l = refine_plain(S, images, masks, **kw)
    v1_m, v1_l = refine_cuda(S, images, masks, plan="v1", **kw)
    for plan in ("v1sym", "v2", "v2_aff") if C == 2 else ("v2", "v2_aff"):
        before = refine_cuda.plan_launches[plan]
        got_m, got_l = refine_cuda(S, images, masks, plan=plan, **kw)
        torch.cuda.synchronize()
        assert refine_cuda.plan_launches[plan] == before + 1
        assert torch.equal(got_m, want_m), plan
        np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-4)
        if plan != "v1sym":
            assert torch.equal(got_m, v1_m) and float(got_l) == float(v1_l), plan
    with pytest.raises(ValueError, match="v1sym"):
        refine_cuda(*_refine_case(3, 1, 16, 16, 3, cuda), plan="v1sym")


def _edge_pixels_by_tile(B, H, W, window, tile):
    """int32 [B, tiles_y, tiles_x]: how many pixels of each tile lie within
    window//2 of an image edge, where the reflect padding gives a pixel more
    than one preimage per offset and the gradient is not 4·Σ aff·d."""
    pad = window // 2
    ys, xs = torch.arange(H)[:, None], torch.arange(W)[None, :]
    near = torch.minimum(torch.minimum(ys, H - 1 - ys), torch.minimum(xs, W - 1 - xs)) <= pad
    ty, tx = -(-H // tile), -(-W // tile)
    padded = torch.zeros((ty * tile, tx * tile), dtype=torch.int32)
    padded[:H, :W] = near.int()
    counts = padded.reshape(ty, tile, tx, tile).sum(dim=(1, 3), dtype=torch.int32)
    return counts.expand(B, ty, tx).contiguous()


@pytest.mark.parametrize("lr", [1e-2, 0.2])
@pytest.mark.parametrize("C", [2, 3])
@pytest.mark.parametrize("loss", ["ncut", "boundary"])
@pytest.mark.parametrize("shape", [(2, 64, 80), (1, 96, 100)])
def test_refine_interior_tiles_every_plan(cuda, shape, loss, C, lr):
    """Shapes with tiles clear of the edges, where the window pass takes
    4·Σ aff·d, beside tiles with pixels near the edge, where it takes the
    gather over the reflect's preimages: every plan's masks equal plain's and
    its loss is within 1e-4; v2 and v2_aff give v1's bits; two launches give
    the same bits."""
    from weaklysuperviseddl_tpu_torch.ops.refine import PLANS, TILE, refine_cuda, refine_plain

    assert bool((_edge_pixels_by_tile(*shape, 5, TILE) == 0).any())
    S, images, masks = _refine_case(4, *shape, C, cuda)
    kw = dict(num_steps=8, lr=lr, loss=loss)
    want_m, want_l = refine_plain(S, images, masks, **kw)
    v1_m, v1_l = refine_cuda(S, images, masks, plan="v1", **kw)
    for plan in PLANS:
        if plan == "v1sym" and C != 2:
            continue
        got_m, got_l = refine_cuda(S, images, masks, plan=plan, **kw)
        again_m, again_l = refine_cuda(S, images, masks, plan=plan, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got_m, want_m), plan
        np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-4)
        assert torch.equal(again_m, got_m) and float(again_l) == float(got_l), plan
        if plan in ("v2", "v2_aff"):
            assert torch.equal(got_m, v1_m) and float(got_l) == float(v1_l), plan
    if lr > 0.1:
        assert (v1_m != (masks == 1)).float().mean().item() > 0.05


@pytest.mark.parametrize("window", [3, 5, 7])
@pytest.mark.parametrize("shape", [(2, 64, 80), (1, 96, 100), (1, 20, 24)])
def test_refine_edge_phase_takes_the_pixels_near_an_edge(cuda, shape, window):
    """The window pass's own count of the pixels its edge phase took, per
    tile, is the count of pixels within window//2 of an edge, for every plan:
    no such pixel takes 4·Σ aff·d, and every tile clear of the edges skips
    the edge phase."""
    from weaklysuperviseddl_tpu_torch.ops.refine import TILE, refine_cuda

    want = _edge_pixels_by_tile(*shape, window, TILE).to(cuda)
    S, images, masks = _refine_case(5, *shape, 2, cuda)
    for plan in ("v1", "v1sym", "v2_aff"):
        got = torch.full_like(want, -1)
        refine_cuda(S, images, masks, num_steps=2, window_size=window, plan=plan,
                    edge_pixels=got)
        torch.cuda.synchronize()
        assert torch.equal(got, want), plan
    with pytest.raises(ValueError, match="edge_pixels"):
        refine_cuda(S, images, masks, edge_pixels=want[:, :1])


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


@pytest.mark.parametrize("loss", ["ncut", "boundary"])
@pytest.mark.parametrize("B,H,W,C,ws", [(2, 11, 13, 2, 3), (2, 16, 24, 3, 5), (2, 9, 32, 2, 7),
                                        (1, 40, 35, 5, 5), (3, 64, 64, 2, 5), (1, 48, 52, 1, 3),
                                        (2, 56, 60, 6, 7)])
def test_window_kernels_equal_plain(cuda, B, H, W, C, ws, loss):
    """The losses through the kernels against the plain losses of
    losses/window.py: values rtol 1e-5, gradients rtol 1e-4 / atol 1e-7 (the
    JAX package's tolerances for its Pallas kernels); two launches give the
    same bits. C=5 and 6 run the kernels' class chunks; 40x35 and the larger
    shapes have tiles clear of the edges at every window (the gradient's
    pair-table path)."""
    from weaklysuperviseddl_tpu_torch.losses.window import boundary_loss, local_normalized_cut_loss
    from weaklysuperviseddl_tpu_torch.ops.window import (
        fused_boundary_loss,
        fused_local_normalized_cut_loss,
        window_sum_cuda,
        window_sum_grad_cuda,
    )

    rng = np.random.default_rng(H * W + C + ws)
    preds = torch.from_numpy(rng.standard_normal((B, H, W, C)).astype(np.float32)).to(cuda)
    images = torch.from_numpy(rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32)).to(cuda)
    if loss == "ncut":
        x = preds
        fused = lambda p: fused_local_normalized_cut_loss(p, images, 0.07, ws)
        plain = lambda p: local_normalized_cut_loss(p, images, 0.07, ws)
    else:
        x = torch.softmax(preds, -1)
        fused = lambda p: fused_boundary_loss(p, images, 0.1, 4.0, ws)
        plain = lambda p: boundary_loss(p, images, 0.1, 4.0, ws)
    results = []
    for fn in (fused, fused, plain):
        p = x.clone().requires_grad_(True)
        before = (window_sum_cuda.launches, window_sum_grad_cuda.launches)
        value = fn(p)
        value.backward()
        torch.cuda.synchronize()
        launched = (window_sum_cuda.launches - before[0], window_sum_grad_cuda.launches - before[1])
        results.append((value.detach(), p.grad, launched))
    (got, got_g, n), (again, again_g, _), (want, want_g, n_plain) = results
    assert n == (1, 1) and n_plain == (0, 0)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    torch.testing.assert_close(got_g, want_g, rtol=1e-4, atol=1e-7)
    assert torch.equal(again, got) and torch.equal(again_g, got_g)


def test_window_wrappers_check_their_input(cuda):
    from weaklysuperviseddl_tpu_torch.ops.window import window_sum_cuda, window_sum_grad_cuda

    probs = torch.rand((1, 12, 12, 2), device=cuda)
    images = torch.rand((1, 12, 12, 3), device=cuda)
    with pytest.raises(TypeError):
        window_sum_cuda(probs.double(), images, 0.1, None, 5)
    with pytest.raises(ValueError):
        window_sum_cuda(probs, images, 0.1, None, 4)
    with pytest.raises(ValueError):
        window_sum_cuda(probs.permute(0, 2, 1, 3), images, 0.1, None, 5)
    with pytest.raises(ValueError):
        window_sum_grad_cuda(probs[:, :3, :3].contiguous(), images[:, :3, :3].contiguous(),
                             0.1, None, 7)


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


def _filter_case(B, Nq, Nk, d, C, scale, cuda, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(a).to(cuda) for a in (
        rng.uniform(0, scale, (B, Nq, d)).astype(np.float32),
        rng.uniform(0, scale, (B, Nk, d)).astype(np.float32),
        rng.uniform(0, 1, (B, Nk, C)).astype(np.float32)))


@pytest.mark.parametrize("B,Nq,Nk,d,C", [(1, 531, 187, 5, 1), (1, 531, 187, 5, 2),
                                         (1, 531, 187, 5, 3), (3, 300, 129, 5, 2),
                                         (1, 200, 150, 20, 128), (2, 77, 65, 3, 9)])
def test_bilateral_kernel_equals_plain(cuda, B, Nq, Nk, d, C):
    """rtol 1e-4, atol 1e-5 (the tolerance the JAX package holds its filter to
    against the literal sum); two launches give the same bits."""
    from weaklysuperviseddl_tpu_torch.ops.bilateral import (
        gaussian_filter_cuda,
        gaussian_filter_plain_cross,
    )

    fq, fk, v = _filter_case(B, Nq, Nk, d, C, 20.0 if d == 5 else 4.0, cuda)
    got = gaussian_filter_cuda(fq, fk, v)
    again = gaussian_filter_cuda(fq, fk, v)
    want = gaussian_filter_plain_cross(fq, fk, v)
    torch.cuda.synchronize()
    assert got.shape == (B, Nq, C)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    assert torch.equal(again, got)


@pytest.mark.parametrize("C", [1, 2])
def test_bilateral_packed_variant_ragged(cuda, C):
    """The CRF's variant (d 5, C 1 or 2: keys packed and padded to the key
    tile, 8 queries per thread) with Nq not a multiple of a block's 1024
    queries and Nk not a multiple of the 256-key tile: rtol 1e-4, atol 1e-5;
    two launches give the same bits."""
    from weaklysuperviseddl_tpu_torch.ops.bilateral import (
        gaussian_filter_cuda,
        gaussian_filter_plain_cross,
    )

    fq, fk, v = _filter_case(2, 2500, 700, 5, C, 6.0, cuda, seed=4)
    got = gaussian_filter_cuda(fq, fk, v)
    again = gaussian_filter_cuda(fq, fk, v)
    want = gaussian_filter_plain_cross(fq, fk, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    assert torch.equal(again, got)


def test_bilateral_fp64_at_reference_magnitudes(cuda):
    """Colours / 5 up to 51 (‖f‖² ≈ 7e3), position / 50: the kernel within
    1e-4 of a float64 sum, relative to the largest output."""
    from weaklysuperviseddl_tpu_torch.ops.bilateral import gaussian_filter_cuda

    rng = np.random.default_rng(0)
    size = 32
    img = rng.integers(0, 255, (size, size, 3)).astype(np.float64)
    yy, xx = np.mgrid[0:size, 0:size] / 50.0
    feats = np.stack([xx, yy] + [img[..., c] / 5.0 for c in range(3)], -1).reshape(1, -1, 5)
    vals = rng.uniform(0, 1, (1, size * size, 2))
    d2 = ((feats[:, :, None, :] - feats[:, None, :, :]) ** 2).sum(-1)
    gold = np.exp(-0.5 * d2) @ vals
    f32 = torch.from_numpy(feats.astype(np.float32)).to(cuda)
    got = gaussian_filter_cuda(f32, f32, torch.from_numpy(vals.astype(np.float32)).to(cuda))
    rel = np.abs(got.cpu().double().numpy() - gold).max() / np.abs(gold).max()
    assert rel <= 1e-4


def test_bilateral_wrapper_routes_and_checks(cuda):
    from weaklysuperviseddl_tpu_torch.ops.bilateral import gaussian_filter_cross, gaussian_filter_cuda

    fq, fk, v = _filter_case(1, 40, 30, 5, 2, 20.0, cuda)
    before = gaussian_filter_cuda.launches
    out = gaussian_filter_cross(fq[0], fk[0], v[0])  # 2-D: one image
    assert out.shape == (40, 2) and gaussian_filter_cuda.launches == before + 1
    with pytest.raises(TypeError):
        gaussian_filter_cuda(fq.double(), fk, v)
    with pytest.raises(ValueError):
        gaussian_filter_cuda(fq[:, ::2], fk, v)
    with pytest.raises(ValueError):
        gaussian_filter_cuda(fq, fk[:, :, :4].contiguous(), v)


def test_crf_masks_on_card_match_cpu(cuda):
    from weaklysuperviseddl_tpu_torch.masks.densecrf import apply_dense_crf

    rng = np.random.default_rng(1)
    images = rng.integers(0, 256, (2, 40, 36, 3)).astype(np.uint8)
    cams = rng.uniform(0, 1, (2, 40, 36)).astype(np.float32)
    for backend in ("attention", "subsampled"):
        cpu = apply_dense_crf(torch.from_numpy(images), torch.from_numpy(cams),
                              bilat_backend=backend)
        gpu = apply_dense_crf(torch.from_numpy(images).to(cuda),
                              torch.from_numpy(cams).to(cuda), bilat_backend=backend)
        assert (gpu.cpu() == cpu).float().mean().item() >= 0.999


@pytest.mark.parametrize("shape", [(3, 160, 14, 14), (2, 130, 7, 9), (4, 64, 56, 56),
                                   (1, 3, 200, 200), (1, 512, 14, 14), (32, 2048, 14, 14),
                                   (40, 1024, 14, 14)])
def test_cam_fusion_kernel_equals_plain(cuda, shape):
    """atol 1e-5: channel sums in another order, then a min-max to [0,1].
    The shapes take every cluster size: 8 CTAs an image at B = 1 to 3, 4 at
    B = 32 (the path's), and at B = 40 (160 CTAs: more than one wave at one
    CTA an SM); 7x9 takes the scalar loads. One launch a call, the card able
    to hold such clusters, and two launches bit-identical."""
    from weaklysuperviseddl_tpu_torch.ops.cam_fusion import (
        cam_fusion_cuda,
        cam_fusion_plain,
        cluster_size,
        max_active_clusters,
        sm_count,
    )

    B, C, h, w = shape
    rng = np.random.default_rng(2)
    act, grad = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)
                 for _ in range(2))
    S = cluster_size(B, C, sm_count(act.device))
    assert max_active_clusters(C, h * w, S, (h * w) % 4 == 0) >= 1
    before = cam_fusion_cuda.launches
    got = cam_fusion_cuda(act, grad)
    assert cam_fusion_cuda.launches == before + 1
    again = cam_fusion_cuda(act, grad)
    want = cam_fusion_plain(act, grad)
    torch.cuda.synchronize()
    assert got.shape == (B, h, w)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert torch.equal(again, got)


@pytest.mark.parametrize("shape", [(3, 160, 14, 14), (2, 130, 7, 9), (1, 512, 14, 14),
                                   (32, 2048, 14, 14), (32, 1024, 14, 14)])
def test_cam_fusion_bf16_equals_kernel_on_the_upcasts(cuda, shape):
    """bfloat16 act and grad: bit-equal to the kernel on their float32
    upcasts (the same sums in the same order; 7x9 takes the scalar loads),
    within 1e-5 of plain, two launches identical, counted as bfloat16."""
    from weaklysuperviseddl_tpu_torch.ops.cam_fusion import (
        cam_fusion,
        cam_fusion_cuda,
        cam_fusion_plain,
    )

    rng = np.random.default_rng(5)
    act, grad = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)
                 .to(torch.bfloat16) for _ in range(2))
    before = dict(cam_fusion_cuda.launches_by_dtype)
    got = cam_fusion_cuda(act, grad)
    assert cam_fusion_cuda.launches_by_dtype["bfloat16"] == before["bfloat16"] + 1
    upcast = cam_fusion_cuda(act.float(), grad.float())
    again = cam_fusion(act, grad)
    want = cam_fusion_plain(act, grad)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (shape[0], *shape[2:])
    assert torch.equal(got, upcast) and torch.equal(again, got)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    with pytest.raises(TypeError, match="one dtype"):
        cam_fusion_cuda(act, grad.float())


def test_atrous_tap_plan_on_the_card(cuda):
    """The ASPP's tap plan on the card against the dilated convolution
    (float32, TF32 off) and the bfloat16 plan against the CPU's."""
    from weaklysuperviseddl_tpu_torch.models.deeplabv3 import AtrousConv
    from weaklysuperviseddl_tpu_torch.models.resnet import init_weights, set_compute_dtype

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    conv = init_weights(AtrousConv(256, 64, 24), torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 256, 32, 32))
                         .astype(np.float32))
    with torch.no_grad():
        cpu = conv(x)
        card = conv.to(cuda)(x.to(cuda))
        dilated = torch.nn.functional.conv2d(x.to(cuda), conv.weight, None, 1, 24, 24)
        torch.testing.assert_close(card.cpu(), cpu, rtol=0, atol=1e-5)
        torch.testing.assert_close(card, dilated, rtol=0, atol=1e-5)
        set_compute_dtype(conv, "bfloat16")
        bf = conv(x.to(cuda))
        assert bf.dtype == torch.bfloat16
        # one bfloat16 rounding of float32 sums taken in another order
        torch.testing.assert_close(bf.float().cpu(), conv.cpu()(x).float(), rtol=2**-7,
                                   atol=1e-3)


def test_cam_fusion_raises_when_clusters_cannot_launch(cuda, monkeypatch):
    """A cluster size the kernel does not take is an error, not a fallback to
    another plan; nothing is counted."""
    from weaklysuperviseddl_tpu_torch.ops import cam_fusion as module

    act = torch.rand((2, 16, 14, 14), device=cuda)
    monkeypatch.setattr(module, "cluster_size", lambda B, C, sms: 16)
    before = module.cam_fusion_cuda.launches
    with pytest.raises(RuntimeError, match="clusters of 16"):
        module.cam_fusion_cuda(act, act)
    assert module.cam_fusion_cuda.launches == before


def test_layercam_pallas_fusion_launches_the_kernel(cuda):
    from weaklysuperviseddl_tpu_torch.cam.layercam import layercam
    from weaklysuperviseddl_tpu_torch.models.classifier import CamClassifier
    from weaklysuperviseddl_tpu_torch.models.resnet import init_weights
    from weaklysuperviseddl_tpu_torch.ops.cam_fusion import cam_fusion_cuda

    torch.backends.cudnn.allow_tf32 = False
    model = CamClassifier(7, 18, 0.25)
    init_weights(model, torch.Generator().manual_seed(0))
    model = model.to(cuda)
    x = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (2, 64, 64, 3))
                         .astype(np.float32)).to(cuda)
    before = cam_fusion_cuda.launches
    got, _ = layercam(model, x, None, output_size=64, fusion="pallas")
    assert cam_fusion_cuda.launches == before + 2
    want, _ = layercam(model, x, None, output_size=64, fusion="xla")
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_dropout_generator_on_the_card(cuda):
    """The ASPP dropout draws its mask from a generator on the card: one seed,
    one mask; another seed, another; seeding and drawing copy nothing from the
    host (no host-to-device copy in a profiler trace of three steps' worth)."""
    from torch.profiler import ProfilerActivity, profile

    from weaklysuperviseddl_tpu_torch.models.deeplabv3 import DeepLabV3, seed_dropout

    model = DeepLabV3(backbone_depth=18, width_multiplier=0.25).to(cuda).train()
    drop = model.classifier[0].project[3]
    x = torch.rand((4, 64, 32, 32), device=cuda) + 0.5
    seed_dropout(model, 11)
    a = drop(x)
    seed_dropout(model, 11)
    b = drop(x)
    seed_dropout(model, 12)
    c = drop(x)
    assert drop.generator.device == x.device
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert abs((a != 0).float().mean().item() - 0.5) < 0.01
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for seed in range(3):
            seed_dropout(model, seed)
            drop(x)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    assert any("bernoulli" in n for n in names)
    assert not [n for n in names if "HtoD" in n]


def test_snapshot_from_the_card_restores_on_the_cpu_and_back(cuda, tmp_path):
    """A snapshot written from a state on the card restores into a state on the
    CPU bit for bit, and that one's snapshot into a state on the card."""
    from weaklysuperviseddl_tpu_torch.data.mask_store import MaskStore
    from weaklysuperviseddl_tpu_torch.models.deeplabv3 import DeepLabV3
    from weaklysuperviseddl_tpu_torch.train.segmentation import create_seg_state, seg_train_step
    from weaklysuperviseddl_tpu_torch.utils.checkpoint import restore_alternation, save_alternation

    def state(device, seed):
        return create_seg_state(DeepLabV3(backbone_depth=18, width_multiplier=0.25), seed=seed,
                                lr=1e-3, device=device)

    def assert_same(got, want):
        dev = next(got.model.parameters()).device
        for (k, a), b in zip(got.model.state_dict().items(), want.model.state_dict().values()):
            assert a.device == dev and torch.equal(a.cpu(), b.cpu()), k
        opt_a, opt_b = got.optimizer, want.optimizer
        assert all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(opt_a.m + opt_a.v,
                                                                 opt_b.m + opt_b.v))
        assert (opt_a.count, got.step) == (opt_b.count, want.step) == (1, 1)

    card = state(cuda, 0)
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((2, 48, 48, 3), device=cuda, generator=gen)
    masks = torch.randint(0, 2, (2, 48, 48), device=cuda, generator=gen)
    seg_train_step(card, x, masks, torch.ones(2, dtype=torch.bool, device=cuda))
    store = MaskStore()
    rng = np.random.default_rng(0)
    for i in range(3):
        store.put(f"{i:05d}", rng.integers(0, 256, (48, 48, 3), dtype=np.uint8),
                  rng.integers(0, 2, (48, 48)))
    save_alternation(str(tmp_path / "card"), 0, card, store)
    on_cpu, cpu_store, nxt = restore_alternation(str(tmp_path / "card"), state("cpu", 1))
    assert nxt == 1
    assert_same(on_cpu, card)
    np.testing.assert_array_equal(cpu_store.as_arrays()[1], store.as_arrays()[1])
    save_alternation(str(tmp_path / "cpu"), 0, on_cpu, cpu_store)
    back, _, _ = restore_alternation(str(tmp_path / "cpu"), state(cuda, 2))
    assert_same(back, card)


@pytest.mark.parametrize("B,H,W,C,kh,stride,pad,dil,y0,x0,Ho,Wo", [
    (2, 64, 64, 3, 7, 2, 3, 1, 0, 0, 32, 32),       # the stem, C = 3 (scalar loads)
    (2, 16, 16, 64, 3, 1, 1, 1, 0, 0, 16, 16),      # 3x3 (16-byte loads)
    (2, 16, 16, 36, 3, 2, 1, 1, 0, 0, 8, 8),        # C % 16 != 0 (4-byte groups)
    (1, 12, 12, 32, 3, 1, 4, 4, 0, 0, 12, 12),      # dilated
    (3, 1, 1, 64, 1, 1, 0, 1, 0, 0, 1, 1),          # the pooled branch: M = B
    (2, 10, 10, 48, 1, 1, 0, 1, 3, 2, 7, 5),        # an ASPP tap's region
])
def test_qconv_kernels_equal_plain(cuda, B, H, W, C, kh, stride, pad, dil, y0, x0, Ho, Wo):
    """Q1 and Q2 (written, added into a region, with a bias and with the
    folded BatchNorm) bit for bit against their plain versions; the GEMM
    exact against a float64 product."""
    from weaklysuperviseddl_tpu_torch.ops import qconv

    rng = np.random.default_rng(H * W + C)
    x = torch.from_numpy((rng.normal(size=(B, H, W, C)) * 4).astype(np.float32)).to(cuda)
    g = qconv.Geometry(kh, kh, stride, pad, dil, y0, x0, Ho, Wo)
    N = 40
    Mp, Kp, Np = qconv.padded(B * Ho * Wo, kh * kh * C, N)
    before = qconv.quantize_gather.launches
    a = qconv.quantize_gather(x, 9.7, g, Mp, Kp)
    assert qconv.quantize_gather.launches == before + 1
    assert torch.equal(a, qconv.quantize_gather_plain(x, 9.7, g, Mp, Kp))
    w = torch.from_numpy(rng.integers(-127, 128, (Np, Kp), dtype=np.int8)).to(cuda)
    acc = qconv.int8_gemm(a, w)
    assert torch.equal(acc, (a.double() @ w.double().t()).to(torch.int32))
    vec = [torch.from_numpy(rng.uniform(0.5, 1.5, N).astype(np.float32)).to(cuda)
           for _ in range(5)]
    out0 = torch.from_numpy(rng.normal(size=(B, Ho + 2, Wo + 3, N)).astype(np.float32)).to(cuda)
    for bias, accumulate, norm in ((None, False, None), (vec[1], False, tuple(vec[2:])),
                                   (None, True, None), (None, True, tuple(vec[2:]))):
        args = (acc, vec[0] * 1e-4, bias)
        region = (Ho, Wo, 1, 2, accumulate, norm)
        got = qconv.dequant_epilogue(*args, out0.clone(), *region)
        want = qconv.dequant_epilogue_plain(*args, out0.clone(), *region)
        assert torch.equal(got, want), (bias is not None, accumulate, norm is not None)


def test_int8_predictor_on_card_equals_cpu(cuda, tmp_path):
    """The int8 program's float steps are the same bits on both devices, so
    one calibration file serves the same masks on the card and on the CPU."""
    import copy

    from weaklysuperviseddl_tpu_torch.models.deeplabv3 import DeepLabV3
    from weaklysuperviseddl_tpu_torch.models.resnet import init_weights
    from weaklysuperviseddl_tpu_torch.ops import qconv
    from weaklysuperviseddl_tpu_torch.pipelines.serve import Predictor

    model = init_weights(DeepLabV3(2, 18, 0.25), torch.Generator().manual_seed(0))
    imgs = (np.random.default_rng(1).uniform(0, 1, (4, 64, 64, 3)) * 255).astype(np.uint8)
    gpu = Predictor(copy.deepcopy(model), size=64, max_batch=4, clean=True, device=cuda)
    cpu = Predictor(model, size=64, max_batch=4, clean=True, device="cpu")
    cpu.quantize(imgs, state_path=str(tmp_path / "calib.json"))
    gpu.quantize(state_path=str(tmp_path / "calib.json"))
    before = qconv.dequant_epilogue.launches
    got = gpu(imgs)
    assert qconv.dequant_epilogue.launches > before
    np.testing.assert_array_equal(got, cpu(imgs))


@pytest.mark.parametrize("inputs", ["pets", "noise"])
def test_basnet_on_card_equals_cpu(cuda, inputs):
    """BASNet's saliency for 64² images (the engine's resize to 256² and
    normalisation) and its eight maps on a 64² input, on the card against the
    same weights on the CPU, within 1e-4, in float32 with TF32 off as the
    port computes (with TF32 on, 2-3e-4 apart)."""
    import copy

    from weaklysuperviseddl_tpu_torch.data.dataset import download_data
    from weaklysuperviseddl_tpu_torch.data.preprocess import normalize_images, preprocess_batch
    from weaklysuperviseddl_tpu_torch.pipelines.basnet_infer import (
        build_basnet,
        norm_pred,
        saliency_dout,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_basnet(device="cpu", generator=torch.Generator().manual_seed(0))
    card = copy.deepcopy(model).to(cuda)
    if inputs == "pets":
        imgs = np.stack(download_data(None, split="test", synthetic_size=2, image_size=64).images)
    else:
        imgs = (np.random.default_rng(3).uniform(0, 1, (2, 64, 64, 3)) * 255).astype(np.uint8)
    imgs = torch.from_numpy(imgs)
    want, got = saliency_dout(model, imgs), saliency_dout(card, imgs.to(cuda)).cpu()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    assert ((norm_pred(got) > 0.5) == (norm_pred(want) > 0.5)).float().mean() >= 0.999
    x, _ = preprocess_batch(imgs, None, size=64)
    x = normalize_images(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        want, got = model(x), card(x.to(cuda))
    for w, g in zip(want, got):
        assert g.shape == (2, 1, 64, 64)
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=1e-4)


def test_basnet_pngs_without_pil_raise_before_the_forward(cuda, monkeypatch, tmp_path):
    """Where PIL is not installed (the card's host), run_inference with an
    output folder raises ImportError before the model runs."""
    import builtins

    from weaklysuperviseddl_tpu_torch.data.dataset import download_data
    from weaklysuperviseddl_tpu_torch.pipelines.basnet_infer import build_basnet, run_inference

    model = build_basnet(device=cuda)
    calls = []
    model.register_forward_pre_hook(lambda *_: calls.append(1))
    real_import = builtins.__import__

    def no_pil(name, *args, **kwargs):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("No module named 'PIL'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    ds = download_data(None, split="test", synthetic_size=2)
    with pytest.raises(ImportError, match="PIL"):
        run_inference(ds, model=model, num_images=2, output_folder=str(tmp_path / "out"))
    assert not calls and not (tmp_path / "out").exists()
    _, iou, acc = run_inference(ds, model=model, num_images=2, output_folder=None,
                                log=lambda *_: None)
    assert calls and 0.0 <= iou <= 1.0 and 0.0 <= acc <= 1.0
