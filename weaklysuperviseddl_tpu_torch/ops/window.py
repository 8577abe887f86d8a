"""The window-affinity sum and its gradient on the card: the wrappers of
``csrc/window.cu``, their plain PyTorch versions, and the losses built on them
(port of weaklysuperviseddl_tpu/ops/pallas_window.py).

    sum = Σ_o Σ_c Σ_p aff_o(p)·(S_c(p) − S_c(reflect(p+o)))²

over the win²−1 offsets of a reflect-padded odd window (3-7), ``aff`` the
colour affinity of ``losses/window.py`` (with its spatial term when
``sigma_space`` is given: the boundary loss). ``FusedWindowSum`` is the
autograd Function: forward one launch of the sum kernel, backward one launch
of the gradient kernel times the incoming gradient; images get no gradient,
as the JAX ``custom_vjp`` gives them zeros. On CPU tensors it runs the plain
pair. The kernels are built with ``nvcc`` at first use (``ops/build.py``) and
loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from weaklysuperviseddl_tpu_torch.losses.window import _window_terms, window_offsets
from weaklysuperviseddl_tpu_torch.ops.build import build, launch_device, stream_handle

SOURCE = "window.cu"
MAX_WINDOW = 7       # windows 3, 5 and 7

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build(SOURCE)))
        lib.wsdl_window_sum.argtypes = (
            [ctypes.c_void_p] * 4          # probs, images, partials (scratch), out
            + [ctypes.c_int] * 5           # B, H, W, C, window
            + [ctypes.c_float]             # inv2sc
            + [ctypes.c_void_p] * 2        # float spatial[window²] (host), stream
        )
        lib.wsdl_window_sum.restype = ctypes.c_int
        lib.wsdl_window_sum_grad.argtypes = (
            [ctypes.c_void_p] * 4          # probs, images, gscale (one float), grad
            + [ctypes.c_int] * 5           # B, H, W, C, window
            + [ctypes.c_float]             # inv2sc
            + [ctypes.c_void_p] * 2        # float spatial[window²] (host), stream
        )
        lib.wsdl_window_sum_grad.restype = ctypes.c_int
        _lib = lib
    return _lib


def window_sum_plain(probs, images, sigma_color, sigma_space, window_size):
    """The plain version of the sum, a 0-dim tensor (differentiable)."""
    total = 0.0
    for aff, diff2 in _window_terms(probs, images, window_size, sigma_color, sigma_space):
        total = total + (aff[:, None] * diff2).sum()
    return total


def window_sum_grad_plain(probs, images, sigma_color, sigma_space, window_size):
    """The plain version of the gradient of the sum with respect to probs."""
    with torch.enable_grad():
        p = probs.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(
            window_sum_plain(p, images.detach(), sigma_color, sigma_space, window_size), p)
    return g


def _check(name, probs, images, window_size):
    for arg, t in (("probs", probs), ("images", images)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} needs CUDA tensors, {arg} is on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors ({arg} is not)")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} takes float32 probs and images, {arg} is {t.dtype}")
    if probs.ndim != 4 or images.ndim != 4:
        raise ValueError(f"{name} takes probs [B,H,W,C] and images [B,H,W,3]")
    B, H, W, C = probs.shape
    if images.shape != (B, H, W, 3):
        raise ValueError(f"shapes disagree: probs {tuple(probs.shape)}, images "
                         f"{tuple(images.shape)}")
    if probs.device != images.device:
        raise ValueError("probs and images must be on one device")
    if window_size % 2 == 0 or not 3 <= window_size <= MAX_WINDOW:
        raise ValueError(f"{name} takes odd windows 3..{MAX_WINDOW}, got {window_size}")
    pad = window_size // 2
    if H <= pad or W <= pad:
        raise ValueError(f"reflect padding needs H and W > {pad}, got {H}x{W}")
    if C < 1 or B > 65535 or B * H * W * C >= 2**31:
        raise ValueError(f"{name} cannot take probs of shape {tuple(probs.shape)}")


@functools.lru_cache(maxsize=64)
def spatial_table(window_size: int, sigma_space):
    """The spatial term of every offset (dy, dx) of the window, row-major, as
    the kernels take it: rounded to float32 as the plain version's is (0
    without ``sigma_space``). Cached: callers pass its address and never
    write it."""
    pad = window_size // 2
    table = (ctypes.c_float * (window_size * window_size))()
    if sigma_space is not None:
        for i, (dy, dx) in enumerate((dy, dx) for dy in range(-pad, pad + 1)
                                     for dx in range(-pad, pad + 1)):
            table[i] = (dy * dy + dx * dx) / (2.0 * sigma_space ** 2)
    return table


@functools.lru_cache(maxsize=16)
def _one(device):
    """A float32 1 on ``device``, made once: the gradient kernel's scale
    when the caller gives none (the kernel only reads it)."""
    return torch.ones((), dtype=torch.float32, device=device)


def window_sum_cuda(probs, images, sigma_color, sigma_space, window_size):
    """The sum kernel: probs [B,H,W,C] and images [B,H,W,3], contiguous
    float32 CUDA tensors on one device → a 0-dim tensor, launched on the
    current stream without synchronising. Raises on anything the kernel does
    not take."""
    _check("window_sum_cuda", probs, images, window_size)
    B, H, W, C = probs.shape
    dev = probs.device
    # one buffer: the sum, then the kernel's B·tiles partials (scratch)
    tiles = ((H + 15) // 16) * ((W + 15) // 16)
    buf = torch.empty((1 + B * tiles,), dtype=torch.float32, device=dev)
    out = buf[0]
    if B == 0:
        return out.zero_()
    spatial = spatial_table(window_size, sigma_space)
    lib = _load()
    stream = stream_handle(dev)
    with launch_device(dev):
        at = buf.data_ptr()
        err = lib.wsdl_window_sum(probs.data_ptr(), images.data_ptr(), at + 4, at, B, H, W, C,
                                  window_size, 1.0 / (2.0 * sigma_color ** 2),
                                  ctypes.addressof(spatial), stream)
    if err != 0:
        raise RuntimeError(f"window_sum launch failed with cudaError {err}")
    window_sum_cuda.launches += 1
    return out


window_sum_cuda.launches = 0  # sums computed by the kernel since the last reset


def window_sum_grad_cuda(probs, images, sigma_color, sigma_space, window_size, scale=None):
    """The gradient kernel: d sum / d probs times ``scale`` (a float32 CUDA
    scalar tensor on the device of probs, 1 if None), [B,H,W,C], launched on
    the current stream without synchronising. Same checks as
    ``window_sum_cuda``."""
    _check("window_sum_grad_cuda", probs, images, window_size)
    B, H, W, C = probs.shape
    dev = probs.device
    if scale is None:
        scale = _one(dev)
    if scale.numel() != 1 or scale.device != dev or scale.dtype != torch.float32:
        raise ValueError("scale must be one float32 value on the device of probs")
    scale = scale.contiguous()
    grad = torch.empty_like(probs)
    if B == 0:
        return grad
    spatial = spatial_table(window_size, sigma_space)
    lib = _load()
    stream = stream_handle(dev)
    with launch_device(dev):
        err = lib.wsdl_window_sum_grad(probs.data_ptr(), images.data_ptr(), scale.data_ptr(),
                                       grad.data_ptr(), B, H, W, C, window_size,
                                       1.0 / (2.0 * sigma_color ** 2), ctypes.addressof(spatial),
                                       stream)
    if err != 0:
        raise RuntimeError(f"window_sum_grad launch failed with cudaError {err}")
    window_sum_grad_cuda.launches += 1
    return grad


window_sum_grad_cuda.launches = 0  # gradients computed by the kernel since the last reset


class FusedWindowSum(torch.autograd.Function):
    """The window sum, differentiable with respect to probs only."""

    @staticmethod
    def forward(ctx, probs, images, sigma_color, sigma_space, window_size):
        ctx.save_for_backward(probs, images)
        ctx.params = (sigma_color, sigma_space, window_size)
        if probs.is_cuda:
            return window_sum_cuda(probs, images, sigma_color, sigma_space, window_size)
        return window_sum_plain(probs, images, sigma_color, sigma_space, window_size)

    @staticmethod
    def backward(ctx, g):
        probs, images = ctx.saved_tensors
        if probs.is_cuda:
            gp = window_sum_grad_cuda(probs, images, *ctx.params, scale=g.float())
        else:
            gp = window_sum_grad_plain(probs, images, *ctx.params) * g
        return gp, None, None, None, None


def fused_window_sum(probs, images, sigma_color, sigma_space, window_size):
    """Σ_o Σ_c Σ_p aff·(ΔS_c)², differentiable with respect to probs (images
    get no gradient): the kernels on CUDA tensors, the plain pair on CPU ones."""
    return FusedWindowSum.apply(probs.float().contiguous(), images.float().contiguous(),
                                sigma_color, sigma_space, window_size)


def fused_local_normalized_cut_loss(preds, images, sigma_color=0.05, window_size=5):
    """losses/window.local_normalized_cut_loss through the kernels: takes
    logits and softmaxes them, as the reference does."""
    B, H, W, C = preds.shape
    probs = torch.softmax(preds, dim=-1)
    K = len(window_offsets(window_size))
    return fused_window_sum(probs, images, sigma_color, None, window_size) * (
        1.0 / (B * H * W * K * C))


def fused_boundary_loss(probs, images, sigma_color=0.1, sigma_space=5.0, window_size=5):
    """losses/window.boundary_loss through the kernels."""
    B, H, W, _ = probs.shape
    K = len(window_offsets(window_size))
    return fused_window_sum(probs, images, sigma_color, sigma_space, window_size) * (
        1.0 / (B * H * W * K))
