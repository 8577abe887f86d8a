"""The int8 convolution of the port's int8 serving: the wrappers of
``csrc/qconv.cu`` and their plain PyTorch versions.

A quantized site (``ops/quant.py``) runs as three steps:

  * ``quantize_gather`` (Q1): an fp32 NHWC activation → the int8 patch
    matrix [Mp, Kp] of the site's convolution (round half to even, clip
    ±127, zero padding, stride, dilation, and a source region for an ASPP
    tap), rows and columns padded with zeros to the GEMM's sizes (``padded``);
  * ``int8_gemm``: the exact int32 product with the int8 weights [Np, Kp];
  * ``dequant_epilogue`` (Q2): float(acc) · rescale[n] (+ bias[n]) written to
    the fp32 NHWC output, or added into a region of it, then the eval
    BatchNorm that follows the conv, in flax's order (``norm``).

In the JAX package the int8 convolution is XLA's, so no TPU kernel is
replaced. Q1 and Q2 are CUDA kernels on a CUDA tensor and their plain
versions on a CPU tensor; there is no fallback between the two. The GEMM is
``torch._int_mm`` (cuBLASLt) on the card, the library's product as JAX
leaves it to XLA, and on the CPU a float64 product, exact for these sizes
(|sum| ≤ 127² · K < 2^53). Each CUDA call adds one to its function's
``launches``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from weaklysuperviseddl_tpu_torch.ops.build import build, launch_device, stream_handle

SOURCE = "qconv.cu"
INDEX_LIMIT = 2**31  # the kernels index rows and columns in 32 bits

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build(SOURCE)))
        lib.wsdl_quantize_gather.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 15
                                             + [ctypes.c_float, ctypes.c_void_p])
        lib.wsdl_quantize_gather.restype = ctypes.c_int
        lib.wsdl_dequant_epilogue.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
                                              + [ctypes.c_void_p])
        lib.wsdl_dequant_epilogue.restype = ctypes.c_int
        _lib = lib
    return _lib


class Geometry(NamedTuple):
    """A site's patch matrix: kernel, stride, symmetric zero padding and
    dilation; the origin (y0, x0) of the source region in the input (an
    ASPP tap's, else 0); the output pixels (Ho, Wo) an image."""

    kh: int
    kw: int
    stride: int
    pad: int
    dil: int
    y0: int
    x0: int
    Ho: int
    Wo: int


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def padded(M: int, K: int, N: int) -> tuple[int, int, int]:
    """(Mp, Kp, Np): the GEMM's rows, depth and columns padded to what
    ``torch._int_mm`` takes on the card (more than 16 rows, depth and columns
    multiples of 8) and Q1 writes (depth a multiple of 16): the pooled ASPP
    branch has M = B, the head's last conv N = 2."""
    return max(_round_up(M, 8), 32), _round_up(K, 16), _round_up(N, 8)


def quantize_plain(x: torch.Tensor, inv: float) -> torch.Tensor:
    """clip(round_half_even(x · inv), ±127) as float32 (exact integers);
    ``inv`` is rounded to float32 first, as the kernel and JAX take it."""
    inv32 = torch.tensor(np.float32(inv), dtype=torch.float32, device=x.device)
    return torch.round(x.float() * inv32).clamp_(-127, 127)


def quantize_gather_plain(x: torch.Tensor, inv: float, g: Geometry, Mp: int,
                          Kp: int) -> torch.Tensor:
    """The plain version of ``quantize_gather``: quantize, then gather the
    patches with ``F.unfold`` (or slice a tap's region), columns reordered
    to (ky, kx, c)."""
    B, H, W, C = x.shape
    q = quantize_plain(x, inv)
    if (g.kh, g.kw, g.stride, g.pad) == (1, 1, 1, 0):
        patches = q[:, g.y0:g.y0 + g.Ho, g.x0:g.x0 + g.Wo, :].reshape(-1, C)
    else:
        if (g.y0, g.x0) != (0, 0):
            raise ValueError("a source region is a 1x1, stride-1, unpadded gather")
        cols = F.unfold(q.permute(0, 3, 1, 2), (g.kh, g.kw), dilation=g.dil, padding=g.pad,
                        stride=g.stride)                                   # [B, C*kh*kw, L]
        patches = (cols.reshape(B, C, g.kh * g.kw, g.Ho * g.Wo).permute(0, 3, 2, 1)
                   .reshape(B * g.Ho * g.Wo, g.kh * g.kw * C))
    M, K = patches.shape
    out = torch.zeros((Mp, Kp), dtype=torch.int8, device=x.device)
    out[:M, :K] = patches.to(torch.int8)
    return out


def quantize_gather(x: torch.Tensor, inv: float, g: Geometry, Mp: int, Kp: int) -> torch.Tensor:
    """[B,H,W,C] float32 contiguous (NHWC) → int8 patches [Mp, Kp]: row
    ((b·Ho + oy)·Wo + ox), column ((ky·kw + kx)·C + c), zeros past
    M = B·Ho·Wo and K = kh·kw·C. The CUDA kernel on a CUDA tensor (launched
    on the current stream, not synchronised), the plain version on a CPU
    tensor; raises on anything else."""
    if x.dtype != torch.float32 or x.ndim != 4 or not x.is_contiguous():
        raise ValueError(f"quantize_gather takes a contiguous float32 [B,H,W,C] tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    B, H, W, C = x.shape
    if B * g.Ho * g.Wo > Mp or g.kh * g.kw * C > Kp or Kp % 16:
        raise ValueError(f"patches of {B * g.Ho * g.Wo} x {g.kh * g.kw * C} do not fit "
                         f"[{Mp}, {Kp}] (Kp a multiple of 16)")
    if x.device.type == "cpu":
        return quantize_gather_plain(x, inv, g, Mp, Kp)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_gather runs on CUDA or CPU tensors, got {x.device}")
    if Mp * Kp >= INDEX_LIMIT or x.numel() >= INDEX_LIMIT:
        raise ValueError(f"quantize_gather: [{Mp}, {Kp}] from {tuple(x.shape)} is too large "
                         "for one launch")
    out = torch.empty((Mp, Kp), dtype=torch.int8, device=x.device)
    with launch_device(x.device):
        err = _load().wsdl_quantize_gather(
            x.data_ptr(), out.data_ptr(), B, H, W, C, g.Ho, g.Wo, g.kh, g.kw, g.stride, g.pad,
            g.dil, g.y0, g.x0, Kp, Mp, ctypes.c_float(np.float32(inv)),
            stream_handle(x.device))
    if err != 0:
        raise RuntimeError(f"quantize_gather launch failed with cudaError {err}")
    quantize_gather.launches += 1
    return out


quantize_gather.launches = 0  # launches of the kernel since the last reset


def int8_gemm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int8 [Mp, Kp] x int8 [Np, Kp]ᵀ → int32 [Mp, Np], exact:
    ``torch._int_mm`` on CUDA tensors, a float64 product on CPU ones."""
    if a.dtype != torch.int8 or w.dtype != torch.int8 or a.shape[1] != w.shape[1]:
        raise ValueError(f"int8_gemm takes int8 [M,K] and [N,K], got {a.dtype} "
                         f"{tuple(a.shape)} and {w.dtype} {tuple(w.shape)}")
    if a.device.type == "cpu":
        return (a.double() @ w.double().t()).to(torch.int32)
    out = torch._int_mm(a, w.t())
    int8_gemm.launches += 1
    return out


int8_gemm.launches = 0  # torch._int_mm calls since the last reset


def dequant_epilogue_plain(acc: torch.Tensor, rescale: torch.Tensor, bias: torch.Tensor | None,
                           out: torch.Tensor, h: int, w: int, oy0: int = 0, ox0: int = 0,
                           accumulate: bool = False, norm=None) -> torch.Tensor:
    """The plain version of ``dequant_epilogue``: the same separately
    rounded float32 operations, one torch op each."""
    B, _, _, N = out.shape
    v = acc[:B * h * w, :N].float() * rescale
    if bias is not None:
        v = v + bias
    region = out[:, oy0:oy0 + h, ox0:ox0 + w, :]
    v = v.reshape(B, h, w, N)
    if accumulate:
        v = region + v
    if norm is not None:
        mean, mul, beta = norm
        v = (v - mean) * mul + beta
    region.copy_(v)
    return out


def dequant_epilogue(acc: torch.Tensor, rescale: torch.Tensor, bias: torch.Tensor | None,
                     out: torch.Tensor, h: int, w: int, oy0: int = 0, ox0: int = 0,
                     accumulate: bool = False, norm=None) -> torch.Tensor:
    """int32 acc [Mp, Np] → its first B·h·w rows and N columns times
    ``rescale`` [N] (+ ``bias`` [N]) as float32, written into (or, with
    ``accumulate``, added to) the region [oy0, oy0+h) x [ox0, ox0+w) of
    ``out`` [B, outH, outW, N] (float32, contiguous), in place; ``norm``
    (mean, mul, beta), each [N], then applies (v − mean) · mul + beta, the
    eval BatchNorm in flax's order. Returns ``out``. The CUDA kernel on CUDA
    tensors, the plain version on CPU ones."""
    if out.dtype != torch.float32 or out.ndim != 4 or not out.is_contiguous():
        raise ValueError("dequant_epilogue writes a contiguous float32 [B,H,W,N] tensor")
    B, outH, outW, N = out.shape
    M = B * h * w
    if (acc.dtype != torch.int32 or acc.ndim != 2 or not acc.is_contiguous()
            or acc.shape[0] < M or acc.shape[1] < N or oy0 + h > outH or ox0 + w > outW):
        raise ValueError(f"dequant_epilogue: acc {acc.dtype} {tuple(acc.shape)} does not hold "
                         f"{M} x {N} for region ({oy0}, {ox0}, {h}, {w}) of {tuple(out.shape)}")
    vectors = (rescale, bias) + (tuple(norm) if norm is not None else ())
    for t in vectors:
        if t is not None and (t.dtype != torch.float32 or t.shape != (N,)
                              or not t.is_contiguous() or t.device != out.device):
            raise ValueError(f"dequant_epilogue: rescale, bias and norm are float32 [{N}] on "
                             f"{out.device}")
    if out.device.type == "cpu":
        return dequant_epilogue_plain(acc, rescale, bias, out, h, w, oy0, ox0, accumulate, norm)
    if out.device.type != "cuda":
        raise ValueError(f"dequant_epilogue runs on CUDA or CPU tensors, got {out.device}")
    if acc.numel() >= INDEX_LIMIT:
        raise ValueError(f"dequant_epilogue: acc {tuple(acc.shape)} is too large for one launch")
    mean, mul, beta = (None, None, None) if norm is None else (t.data_ptr() for t in norm)
    with launch_device(out.device):
        err = _load().wsdl_dequant_epilogue(
            acc.data_ptr(), out.data_ptr(), rescale.data_ptr(),
            None if bias is None else bias.data_ptr(), mean, mul, beta, M, N, acc.shape[1], h,
            w, outH, outW, oy0, ox0, int(accumulate), stream_handle(out.device))
    if err != 0:
        raise RuntimeError(f"dequant_epilogue launch failed with cudaError {err}")
    dequant_epilogue.launches += 1
    return out


dequant_epilogue.launches = 0  # launches of the kernel since the last reset
