"""Exact high-dimensional Gaussian filtering: the wrapper of ``csrc/bilateral.cu``
and its plain PyTorch version (port of weaklysuperviseddl_tpu/ops/pallas_bilateral.py).

The dense CRF's bilateral message pass needs, per mean-field iteration,

    out_i = Σ_j exp(-½‖fq_i - fk_j‖²) · v_j            (f ∈ R^d, v ∈ R^C)

over a batch: feats_q [B,Nq,d], feats_k [B,Nk,d], values [B,Nk,C] →
[B,Nq,C] (2-D inputs, as the JAX functions take, are one image).
``gaussian_filter_cross`` launches the CUDA kernel on CUDA tensors and runs
the plain version on CPU tensors; the kernel takes any d and any C, so the
JAX package's routing by d does not carry over.

Precision: the exponent carries ‖f‖² of about 7e3 at the reference CRF
parameters, and any reduced-precision product there (bf16 on the TPU's
matrix unit, TF32 here) makes exp() garbage. Both versions therefore sum
squared differences in fp32, never an expanded ‖fq‖² + ‖fk‖² − 2 fq·fk
(``torch.cdist`` switches to that form, and a float32 ``torch.matmul`` may
run in TF32).

Not ported: the TPU kernel's ``plan`` ("mxu"/"vpu"), a choice between two
ways of computing the exponent on the TPU, and the random-Fourier-feature
factorisation (``rff_basis``, ``gaussian_filter_rff``), an XLA path of the
CRF's "rff" backend, which ``masks/densecrf.py`` refuses.
"""

from __future__ import annotations

import ctypes
import math

import torch

from weaklysuperviseddl_tpu_torch.ops.build import build, stream_handle

SOURCE = "bilateral.cu"
MAX_FEATURES = 128        # the kernel's shared-memory tiles hold d ≤ 128
# The kernel's CRF variant (d 5, C ≤ 2) scales every feature by this before
# differencing, so that exp(-½‖fq − fk‖²) = 2^(−‖s·fq − s·fk‖²): one exp2
# instruction per key pair and no multiply by −½ (csrc/bilateral.cu).
EXP2_SCALE = math.sqrt(0.5 * math.log2(math.e))
PLAIN_CHUNK = 1 << 24     # elements of one [queries, keys] block of the plain version

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build(SOURCE)))
        lib.wsdl_bilateral.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                                       + [ctypes.c_float, ctypes.c_void_p])
        lib.wsdl_bilateral.restype = ctypes.c_int
        lib.wsdl_bilateral_scratch_bytes.argtypes = [ctypes.c_int] * 4
        lib.wsdl_bilateral_scratch_bytes.restype = ctypes.c_longlong
        _lib = lib
    return _lib


def _batched(feats_q, feats_k, values):
    """(fq, fk, v as [B,...], whether the inputs were 2-D); raises on shapes
    that disagree."""
    if feats_q.ndim != feats_k.ndim or feats_q.ndim != values.ndim or feats_q.ndim not in (2, 3):
        raise ValueError("gaussian filter takes [Nq,d], [Nk,d], [Nk,C] or the same with a "
                         f"leading batch dimension, got {tuple(feats_q.shape)}, "
                         f"{tuple(feats_k.shape)}, {tuple(values.shape)}")
    single = feats_q.ndim == 2
    if single:
        feats_q, feats_k, values = feats_q[None], feats_k[None], values[None]
    B, _, d = feats_q.shape
    if feats_k.shape[0] != B or values.shape[0] != B or feats_k.shape[2] != d \
            or values.shape[1] != feats_k.shape[1]:
        raise ValueError(f"shapes disagree: feats_q {tuple(feats_q.shape)}, feats_k "
                         f"{tuple(feats_k.shape)}, values {tuple(values.shape)}")
    return feats_q, feats_k, values, single


def gaussian_filter_plain_cross(feats_q, feats_k, values):
    """The plain version, the counterpart of JAX's ``gaussian_filter_xla_cross``:
    the exponent as −½·Σ_k (fq_k − fk_k)² in explicit fp32 differences, the
    value sum as an fp32 reduction over keys (no matmul, so TF32 cannot reach
    it), in blocks of queries so that the [Nq,Nk] kernel matrix is never held
    whole (2.5 GB per image at 224² against a stride-2 key grid)."""
    fq, fk, v, single = _batched(feats_q, feats_k, values)
    fq, fk, v = fq.float(), fk.float(), v.float()
    B, Nq, d = fq.shape
    Nk, C = v.shape[1], v.shape[2]
    out = torch.empty((B, Nq, C), dtype=torch.float32, device=fq.device)
    step = max(1, PLAIN_CHUNK // max(Nk, 1))
    for b in range(B):
        for q0 in range(0, Nq, step):
            q = fq[b, q0:q0 + step]
            expo = torch.zeros((q.shape[0], Nk), dtype=torch.float32, device=fq.device)
            for k in range(d):
                t = q[:, k, None] - fk[b, None, :, k]
                expo.addcmul_(t, t)
            w = expo.mul_(-0.5).exp_()
            for c in range(C):
                out[b, q0:q0 + step, c] = (w * v[b, None, :, c]).sum(dim=1)
    return out[0] if single else out


def gaussian_filter_cuda(feats_q, feats_k, values):
    """The kernel: feats_q [B,Nq,d], feats_k [B,Nk,d], values [B,Nk,C],
    contiguous float32 CUDA tensors on one device → [B,Nq,C], launched on the
    current stream without synchronising. Raises on anything the kernel does
    not take."""
    for name, t in (("feats_q", feats_q), ("feats_k", feats_k), ("values", values)):
        if t.device.type != "cuda":
            raise ValueError(f"gaussian_filter_cuda needs CUDA tensors, {name} is on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"gaussian_filter_cuda takes float32, {name} is {t.dtype}")
        if t.ndim != 3:
            raise ValueError(f"gaussian_filter_cuda takes [B,N,*] tensors, {name} has shape "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"gaussian_filter_cuda needs contiguous tensors ({name} is not)")
    fq, fk, v, _ = _batched(feats_q, feats_k, values)
    if fq.device != fk.device or fq.device != v.device:
        raise ValueError("feats_q, feats_k and values must be on one device")
    B, Nq, d = fq.shape
    Nk, C = v.shape[1], v.shape[2]
    if not 1 <= d <= MAX_FEATURES:
        raise ValueError(f"gaussian_filter_cuda takes 1..{MAX_FEATURES} features, got {d}")
    if B > 65535 or max(B * Nq * max(d, C), B * Nk * max(d, C)) >= 2**31:
        raise ValueError(f"batch {B}x{Nq}x{Nk} is too large for one launch")
    out = torch.empty((B, Nq, C), dtype=torch.float32, device=fq.device)
    if out.numel() == 0:
        return out
    lib = _load()
    # the packed keys of the CRF variant (none for other d or C)
    scratch = torch.empty((lib.wsdl_bilateral_scratch_bytes(B, Nk, d, C),), dtype=torch.uint8,
                          device=fq.device)
    stream = stream_handle(fq.device)
    with torch.cuda.device(fq.device):
        err = lib.wsdl_bilateral(fq.data_ptr(), fk.data_ptr(), v.data_ptr(), out.data_ptr(),
                                 scratch.data_ptr() if scratch.numel() else None,
                                 B, Nq, Nk, d, C, EXP2_SCALE, stream)
    if err != 0:
        raise RuntimeError(f"bilateral filter launch failed with cudaError {err}")
    gaussian_filter_cuda.launches += 1
    return out


gaussian_filter_cuda.launches = 0  # launches of the kernel since the last reset


def gaussian_filter_cross(feats_q, feats_k, values):
    """The rectangular exact filter, [B,Nq,d] × [B,Nk,d] × [B,Nk,C] → [B,Nq,C]
    (or 2-D, one image): the kernel on CUDA tensors, the plain version on CPU
    tensors. With feats_k a strided subgrid of the pixels it is the primitive
    of the CRF's "subsampled" backend."""
    if feats_q.is_cuda:
        fq, fk, v, single = _batched(feats_q, feats_k, values)
        out = gaussian_filter_cuda(*(t.float().contiguous() for t in (fq, fk, v)))
        return out[0] if single else out
    return gaussian_filter_plain_cross(feats_q, feats_k, values)


# JAX's dispatch twin of gaussian_filter_cross; the port routes by device in
# gaussian_filter_cross itself, so the two are one function
gaussian_filter_rect = gaussian_filter_cross


def gaussian_filter(feats, values):
    """The square exact filter: feats [B,N,d], values [B,N,C] → [B,N,C]."""
    return gaussian_filter_cross(feats, feats, values)
