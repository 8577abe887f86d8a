"""Connected-component labelling on the card: the wrapper of ``csrc/cc.cu``.

Port of the TPU kernel ``weaklysuperviseddl_tpu/ops/pallas_cc.py::_cc_kernel``
(``pallas_label_components_batch``): [B,H,W] binary masks → int32 labels, each
the linear index of its 8-connected component's smallest pixel, -1 for
background. The CUDA kernel is a block-based union-find (see the note at the
top of ``csrc/cc.cu``); it always computes the true fixed point, where the JAX
functions stop after ``max_iters`` rounds.

The kernel is built with ``nvcc`` at first use (``ops/build.py``) and loaded
with ``ctypes``. The plain PyTorch version of the same function is
``masks/components.label_components``.
"""

from __future__ import annotations

import ctypes

import torch

from weaklysuperviseddl_tpu_torch.ops.build import build

SOURCE = "cc.cu"

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build(SOURCE)))
        lib.wsdl_cc_label.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.wsdl_cc_label.restype = ctypes.c_int
        _lib = lib
    return _lib


def label_components_cuda(masks: torch.Tensor) -> torch.Tensor:
    """[B,H,W] uint8 or bool CUDA tensor (nonzero = foreground), contiguous →
    int32 labels [B,H,W] on the same device, launched on the current stream
    without synchronising. Raises on anything the kernel does not take."""
    if masks.device.type != "cuda":
        raise ValueError(f"label_components_cuda needs a CUDA tensor, got {masks.device}")
    if masks.dtype not in (torch.uint8, torch.bool):
        raise TypeError(f"label_components_cuda takes uint8 or bool masks, got {masks.dtype}")
    if masks.ndim != 3:
        raise ValueError(f"label_components_cuda takes [B,H,W], got shape {tuple(masks.shape)}")
    if not masks.is_contiguous():
        raise ValueError("label_components_cuda needs a contiguous tensor")
    B, H, W = masks.shape
    if B > 65535 or B * H * W >= 2**31:
        raise ValueError(f"batch {tuple(masks.shape)} is too large for one launch")
    labels = torch.empty((B, H, W), dtype=torch.int32, device=masks.device)
    if labels.numel() == 0:
        return labels
    lib = _load()
    stream = torch.cuda.current_stream(masks.device).cuda_stream
    with torch.cuda.device(masks.device):
        err = lib.wsdl_cc_label(masks.data_ptr(), labels.data_ptr(), B, H, W, stream)
    if err != 0:
        raise RuntimeError(f"cc_label launch failed with cudaError {err}")
    label_components_cuda.launches += 1
    return labels


label_components_cuda.launches = 0  # launches of the kernel since the last reset
