"""LayerCAM fusion of one layer: the wrapper of ``csrc/cam_fusion.cu`` and its
plain PyTorch version (port of weaklysuperviseddl_tpu/ops/pallas_cam.py).

act, grad [B,C,h,w] (the port's NCHW activations and their gradients) →
relu(Σ_c relu(grad ⊙ act)) → per-image (x − min)/(max − min + 1e-8), [B,h,w].
``cam_fusion`` launches the CUDA kernel on CUDA tensors and runs the plain
version on CPU tensors; ``cam/layercam.py`` reaches it through
``fusion="pallas"``.
"""

from __future__ import annotations

import ctypes

import torch

from weaklysuperviseddl_tpu_torch.ops.build import build

SOURCE = "cam_fusion.cu"
MAX_PIXELS = 50000  # the kernel holds one image's h·w sums in shared memory

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build(SOURCE)))
        lib.wsdl_cam_fusion.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        lib.wsdl_cam_fusion.restype = ctypes.c_int
        _lib = lib
    return _lib


def minmax(cam: torch.Tensor) -> torch.Tensor:
    """Per-image min-max over the trailing two dims: c -= min; c /= (max + 1e-8)."""
    cam = cam - cam.amin(dim=(-2, -1), keepdim=True)
    return cam / (cam.amax(dim=(-2, -1), keepdim=True) + 1e-8)


def cam_fusion_plain(act: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """The plain version: relu(grad ⊙ act) summed over channels, relu, min-max."""
    return minmax(torch.relu(torch.relu(grad * act).sum(dim=1)))


def cam_fusion_cuda(act: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """The kernel: act, grad [B,C,h,w] contiguous float32 CUDA tensors on one
    device → [B,h,w], launched on the current stream without synchronising.
    Raises on anything the kernel does not take."""
    for name, t in (("act", act), ("grad", grad)):
        if t.device.type != "cuda":
            raise ValueError(f"cam_fusion_cuda needs CUDA tensors, {name} is on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"cam_fusion_cuda takes float32, {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"cam_fusion_cuda needs contiguous tensors ({name} is not)")
    if act.ndim != 4 or act.shape != grad.shape:
        raise ValueError(f"cam_fusion_cuda takes act and grad [B,C,h,w] of one shape, got "
                         f"{tuple(act.shape)}, {tuple(grad.shape)}")
    if act.device != grad.device:
        raise ValueError("act and grad must be on one device")
    B, C, h, w = act.shape
    if h * w > MAX_PIXELS or act.numel() >= 2**31:
        raise ValueError(f"cam_fusion_cuda takes h*w <= {MAX_PIXELS} and fewer than 2^31 "
                         f"elements, got {tuple(act.shape)}")
    if C == 0:
        raise ValueError("cam_fusion_cuda needs at least one channel")
    out = torch.empty((B, h, w), dtype=torch.float32, device=act.device)
    if out.numel() == 0:
        return out
    lib = _load()
    stream = torch.cuda.current_stream(act.device).cuda_stream
    with torch.cuda.device(act.device):
        err = lib.wsdl_cam_fusion(act.data_ptr(), grad.data_ptr(), out.data_ptr(), B, C,
                                  h * w, stream)
    if err != 0:
        raise RuntimeError(f"cam_fusion launch failed with cudaError {err}")
    cam_fusion_cuda.launches += 1
    return out


cam_fusion_cuda.launches = 0  # launches of the kernel since the last reset


def cam_fusion(act: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """The fusion of one layer, [B,C,h,w] × [B,C,h,w] → [B,h,w]: the kernel on
    CUDA tensors, the plain version on CPU tensors."""
    if act.is_cuda:
        return cam_fusion_cuda(act.float().contiguous(), grad.float().contiguous())
    return cam_fusion_plain(act, grad)
