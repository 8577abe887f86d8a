"""Alternating-direction mask refinement on the card: the wrapper of
``csrc/refine.cu``, and its plain PyTorch version.

Port of the TPU kernels ``weaklysuperviseddl_tpu/ops/pallas_refine.py::_refine_kernel``
(``pallas_refine``, plans v1/v1sym) and ``::_refine_kernel_v2`` (plans
v2/v2_aff). Per image: X = one_hot(mask); ``num_steps``
Adam steps (β 0.9/0.999, eps 1e-8, bias-corrected) on

    KL(S ‖ softmax X) + λ·W,   λ = λ_b·KL/(W + 1e-6) (a stop-gradient scalar),

W the 24-offset colour-affinity window loss of ``losses/window.py`` (ncut:
of softmax(softmax X); boundary: of softmax X, with a spatial term); then
mask = softmax(X)[1] > threshold.

``refine_plain`` is the autograd path of ``train/refine.py:100-135`` batched,
λ per image as under ``vmap``. ``refine_cuda`` launches the hand-written
kernel (one call per batch; the C entry point runs its launches in stream
order and returns the first CUDA error); ``train/refine.py`` picks one. The
kernel is built with ``nvcc`` at first use (``ops/build.py``) and loaded
with ``ctypes``.

``plan`` takes the TPU kernel's names. "auto" is "v1sym" for C=2, else "v1"
(as ``pallas_refine``'s ``_pick_plan``). "v1sym" (C=2 only) sweeps the window
for class 0 alone and sets g₁ = −g₀. "v2" is the TPU's v1 with its window
backward written as gathers; the kernel's window pass already is that gather,
so "v2" runs "v1". The kernel's window pass takes each pixel pair's
affinity once, from tables it writes once per call ([B, tiles, pairs] float
scratch), and the gradient as 4·Σ_o aff_o·d_o at every pixel more than
window//2 from the image's edges; the pixels nearer an edge take the gather
over the reflect's preimages (its edge phase, whose pixel counts per tile
``refine_cuda`` can return in ``edge_pixels``). "v2_aff" computes the K
affinity planes of each image once, before the steps, and reads them in every
step instead ([B,K,H,W] float scratch); its masks and losses equal "v1"'s.
``refine_plain`` is the golden of every plan: it checks ``plan`` and computes
the same function for each.
"""

from __future__ import annotations

import ctypes

import torch

from weaklysuperviseddl_tpu_torch.losses.window import (
    boundary_per_image,
    local_normalized_cut_per_image,
    window_offsets,
)
from weaklysuperviseddl_tpu_torch.ops.build import build, stream_handle
from weaklysuperviseddl_tpu_torch.ops.window import spatial_table

SOURCE = "refine.cu"
MAX_CLASSES = 4      # the kernel's compile-time class counts: 2, 3, 4
MAX_WINDOW = 7       # windows 3, 5 and 7
TILE = 16            # the window pass's tiles are TILE x TILE pixels

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
PLANS = ("v1", "v1sym", "v2", "v2_aff")
_PLAN_CODES = {"v1": 0, "v1sym": 1, "v2": 0, "v2_aff": 2}  # csrc/refine.cu's Plan

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build(SOURCE)))
        lib.wsdl_refine.argtypes = (
            [ctypes.c_void_p] * 4          # S, images, masks (int32), out (uint8)
            + [ctypes.c_void_p] * 4        # state, partials, loss_acc, aff (scratch)
            + [ctypes.c_void_p]            # edge_pixels (int32, or None)
            + [ctypes.c_int] * 6           # B, H, W, C, window, num_steps
            + [ctypes.c_int] * 2           # plan, double_softmax
            + [ctypes.c_float] * 5         # inv2sc, normW, lambda_b, lr, threshold
            + [ctypes.c_void_p]            # float spatial[window²] (host)
            + [ctypes.c_void_p]            # stream
        )
        lib.wsdl_refine.restype = ctypes.c_int
        lib.wsdl_refine_aff_floats.argtypes = [ctypes.c_int] * 5
        lib.wsdl_refine_aff_floats.restype = ctypes.c_longlong
        _lib = lib
    return _lib


def resolve_plan(plan: str, C: int) -> str:
    """The plan that runs for ``plan`` at C classes; raises ValueError on an
    unknown plan and on "v1sym" with C != 2, as ``pallas_refine`` does."""
    if plan == "auto":
        return "v1sym" if C == 2 else "v1"
    if plan not in PLANS:
        raise ValueError(f"unknown refinement plan {plan!r}; expected 'auto' or one of {PLANS}")
    if plan == "v1sym" and C != 2:
        raise ValueError("plan='v1sym' requires C == 2")
    return plan


def _constants(H: int, W: int, C: int, window_size: int, loss: str,
               sigma_color: float, sigma_space: float):
    """(double_softmax, inv2sc, normW, sigma_space or None) of the loss variant."""
    K = len(window_offsets(window_size))
    if loss == "boundary":
        return False, 1.0 / (2.0 * sigma_color ** 2), 1.0 / (H * W * K), sigma_space
    if loss == "ncut":
        return True, 1.0 / (2.0 * sigma_color ** 2), 1.0 / (H * W * K * C), None
    raise ValueError(f"unknown refinement loss {loss!r}")


def _kl_per_image(q: torch.Tensor, S: torch.Tensor) -> torch.Tensor:
    """Σ S·log S − S·log(q + 1e-8) per image (F.kl_div batchmean of one image)."""
    p_log_p = torch.where(S > 0, S * torch.log(torch.where(S > 0, S, torch.ones_like(S))),
                          torch.zeros_like(S))
    return (p_log_p - S * torch.log(q + 1e-8)).sum(dim=(1, 2, 3))


def refine_plain(S, images, masks, lambda_boundary=0.1, threshold=0.5, lr=1e-2,
                 num_steps=20, sigma_color=0.1, sigma_space=5.0, window_size=5,
                 loss="ncut", plan="auto"):
    """The plain PyTorch version: autograd through the window loss, Adam
    written out (the formula optax and the kernel use). Returns (uint8
    [B,H,W], mean over images of Σ_steps loss), the same for every plan."""
    C = S.shape[-1]
    resolve_plan(plan, C)
    S = S.float()
    images = images.float()
    x = torch.nn.functional.one_hot(masks.long(), C).float()
    m = torch.zeros_like(x)
    v = torch.zeros_like(x)
    totals = torch.zeros(S.shape[0], dtype=torch.float32, device=S.device)
    for t in range(num_steps):
        with torch.enable_grad():
            x.requires_grad_(True)
            q = torch.softmax(x, dim=-1)
            kl = _kl_per_image(q, S)
            if loss == "boundary":
                w = boundary_per_image(q, images, sigma_color, sigma_space, window_size)
            elif loss == "ncut":
                # the reference's double softmax: the criterion softmaxes again
                w = local_normalized_cut_per_image(q, images, sigma_color, window_size)
            else:
                raise ValueError(f"unknown refinement loss {loss!r}")
            lam = lambda_boundary * kl.detach() / (w.detach() + 1e-6)
            per_image = kl + lam * w
            (g,) = torch.autograd.grad(per_image.sum(), x)
        x = x.detach()
        totals = totals + per_image.detach()
        bc1 = 1.0 - ADAM_B1 ** (t + 1)
        bc2 = 1.0 - ADAM_B2 ** (t + 1)
        m = ADAM_B1 * m + (1.0 - ADAM_B1) * g
        v = ADAM_B2 * v + (1.0 - ADAM_B2) * (g * g)
        x = x - lr * ((m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS))
    refined = (torch.softmax(x, dim=-1)[..., 1] > threshold).to(torch.uint8)
    return refined, totals.mean()


def refine_cuda(S, images, masks, lambda_boundary=0.1, threshold=0.5, lr=1e-2,
                num_steps=20, sigma_color=0.1, sigma_space=5.0, window_size=5,
                loss="ncut", plan="auto", edge_pixels=None):
    """The kernel: S [B,H,W,C] float32, images [B,H,W,3] float32, masks
    [B,H,W] integer, all contiguous CUDA tensors on one device → (uint8
    [B,H,W], mean loss as a 0-dim tensor), launched on the current stream
    without synchronising. Raises on anything the kernel does not take.

    ``edge_pixels``, if given, is a contiguous int32 tensor [B, ⌈H/TILE⌉,
    ⌈W/TILE⌉] on the same device: every window pass writes there how many
    pixels of each tile its edge phase took (0 for a tile that skipped it)."""
    plan = resolve_plan(plan, S.shape[-1] if S.ndim == 4 else 0)
    for name, t in (("S", S), ("images", images), ("masks", masks)):
        if t.device.type != "cuda":
            raise ValueError(f"refine_cuda needs CUDA tensors, {name} is on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"refine_cuda needs contiguous tensors ({name} is not)")
    if S.dtype != torch.float32 or images.dtype != torch.float32:
        raise TypeError(f"refine_cuda takes float32 S and images, got {S.dtype}, {images.dtype}")
    if masks.dtype not in (torch.uint8, torch.int32, torch.int64):
        raise TypeError(f"refine_cuda takes uint8/int32/int64 masks, got {masks.dtype}")
    if S.ndim != 4 or images.ndim != 4 or masks.ndim != 3:
        raise ValueError("refine_cuda takes S [B,H,W,C], images [B,H,W,3], masks [B,H,W]")
    B, H, W, C = S.shape
    if images.shape != (B, H, W, 3) or masks.shape != (B, H, W):
        raise ValueError(f"shapes disagree: S {tuple(S.shape)}, images "
                         f"{tuple(images.shape)}, masks {tuple(masks.shape)}")
    if not 2 <= C <= MAX_CLASSES:
        raise ValueError(f"refine_cuda takes 2..{MAX_CLASSES} classes, got {C}")
    if window_size % 2 == 0 or not 3 <= window_size <= MAX_WINDOW:
        raise ValueError(f"refine_cuda takes odd windows 3..{MAX_WINDOW}, got {window_size}")
    pad = window_size // 2
    if H <= pad or W <= pad:
        raise ValueError(f"reflect padding needs H and W > {pad}, got {H}x{W}")
    if B > 65535 or B * H * W * C >= 2**31:
        raise ValueError(f"batch {tuple(S.shape)} is too large for one launch")
    if S.device != images.device or S.device != masks.device:
        raise ValueError("S, images and masks must be on one device")
    if num_steps < 0:
        raise ValueError("num_steps must be >= 0")
    tiles_y, tiles_x = (H + TILE - 1) // TILE, (W + TILE - 1) // TILE
    if edge_pixels is not None and (
            edge_pixels.shape != (B, tiles_y, tiles_x) or edge_pixels.dtype != torch.int32
            or edge_pixels.device != S.device or not edge_pixels.is_contiguous()):
        raise ValueError(f"edge_pixels must be a contiguous int32 tensor "
                         f"{(B, tiles_y, tiles_x)} on {S.device}")
    double_softmax, inv2sc, normW, sspace = _constants(H, W, C, window_size, loss,
                                                       sigma_color, sigma_space)
    dev = S.device
    out = torch.empty((B, H, W), dtype=torch.uint8, device=dev)
    loss_acc = torch.empty((B,), dtype=torch.float32, device=dev)  # zeroed by the kernel
    if B == 0:
        return out, loss_acc.sum()
    masks32 = masks.to(torch.int32).contiguous()
    state = torch.empty((4, B, H, W, C), dtype=torch.float32, device=dev)  # X, m, v, G
    partials = torch.empty((B, tiles_y * tiles_x, 2), dtype=torch.float32, device=dev)
    lib = _load()
    # v2_aff's affinity planes, or the other plans' pair tables (csrc/refine.cu)
    aff = torch.empty((lib.wsdl_refine_aff_floats(B, H, W, window_size, _PLAN_CODES[plan]),),
                      dtype=torch.float32, device=dev)
    spatial = spatial_table(window_size, sspace)
    stream = stream_handle(dev)
    with torch.cuda.device(dev):
        err = lib.wsdl_refine(
            S.data_ptr(), images.data_ptr(), masks32.data_ptr(), out.data_ptr(),
            state.data_ptr(), partials.data_ptr(), loss_acc.data_ptr(), aff.data_ptr(),
            None if edge_pixels is None else edge_pixels.data_ptr(), B, H, W, C,
            window_size, num_steps, _PLAN_CODES[plan], int(double_softmax),
            inv2sc, normW, lambda_boundary, lr, threshold,
            ctypes.addressof(spatial), stream)
    if err != 0:
        raise RuntimeError(f"refine launch failed with cudaError {err}")
    refine_cuda.launches += 1
    refine_cuda.plan_launches[plan] += 1
    return out, loss_acc.mean()


refine_cuda.launches = 0  # batches refined by the kernel since the last reset
refine_cuda.plan_launches = dict.fromkeys(PLANS, 0)  # the same, by the plan that ran

