"""LayerCAM fusion of one layer: the wrapper of ``csrc/cam_fusion.cu`` and its
plain PyTorch version (port of weaklysuperviseddl_tpu/ops/pallas_cam.py).

act, grad [B,C,h,w] (the port's NCHW activations and their gradients, float32,
bfloat16 or float16) → relu(Σ_c relu(grad ⊙ act)) → per-image
(x − min)/(max − min + 1e-8), [B,h,w] float32, computed in float32: 16-bit
inputs are widened first, as the JAX kernel's ``prep`` upcasts them.
``cam_fusion`` launches the CUDA kernel on CUDA tensors and runs the plain
version on CPU tensors; ``cam/layercam.py`` reaches it through
``fusion="pallas"``. The kernel spreads each image over a thread-block
cluster of ``cluster_size`` CTAs, each summing a slice of the channels. On
bfloat16 or float16 inputs it reads them as they are (half the bytes) and
gives the bits of its float32 launch on their upcasts.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from weaklysuperviseddl_tpu_torch.ops.build import build, launch_device, stream_handle

SOURCE = "cam_fusion.cu"
MAX_PIXELS = 50000  # the kernel holds one image's h·w sums in shared memory
CLUSTER_SIZES = (1, 2, 4, 8)  # CTAs an image; 8 is the card's portable cluster limit

# the inputs the kernel reads, each with the code the C entry points take
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build(SOURCE)))
        lib.wsdl_cam_fusion.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        lib.wsdl_cam_fusion.restype = ctypes.c_int
        lib.wsdl_cam_fusion_max_clusters.argtypes = [ctypes.c_int] * 5
        lib.wsdl_cam_fusion_max_clusters.restype = ctypes.c_int
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=64)
def cluster_size(B: int, C: int, sms: int) -> int:
    """The CTAs of an image's cluster: of ``CLUSTER_SIZES``, at most C, the
    one whose B·S CTAs come nearest to one wave of the card's ``sms``
    streaming multiprocessors (the smaller on a tie): 4 at B = 32 on 132.
    It does not depend on the inputs' type: a 16-bit call splits its sums
    as the float32 call on the upcasts does, which keeps the two bit-equal."""
    return min((s for s in CLUSTER_SIZES if s <= C), key=lambda s: (abs(B * s - sms), s))


@functools.lru_cache(maxsize=8)
def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of a CUDA device, queried once."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def max_active_clusters(C: int, hw: int, S: int, vectorized: bool,
                        dtype: torch.dtype = torch.float32) -> int:
    """How many clusters of S CTAs the current CUDA device holds at once for
    a call with C channels of h·w = ``hw`` pixels on ``dtype`` inputs
    (``vectorized``: the 4-element loads taken when hw % 4 == 0 and the
    tensors are aligned to 4 elements, 4·``dtype.itemsize`` bytes); 0 means
    the kernel could not launch. Raises on a failed query."""
    n = _load().wsdl_cam_fusion_max_clusters(C, hw, S, int(vectorized), DTYPES[dtype])
    if n < 0:
        raise RuntimeError(f"cam_fusion occupancy query failed with cudaError {-n}")
    return n


def minmax(cam: torch.Tensor) -> torch.Tensor:
    """Per-image min-max over the trailing two dims: c -= min; c /= (max + 1e-8)."""
    cam = cam - cam.amin(dim=(-2, -1), keepdim=True)
    return cam / (cam.amax(dim=(-2, -1), keepdim=True) + 1e-8)


def cam_fusion_plain(act: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """The plain version: relu(grad ⊙ act) summed over channels, relu,
    min-max, in float32 (the inputs upcast first, as JAX's ``prep`` does)."""
    act, grad = act.float(), grad.float()
    return minmax(torch.relu(torch.relu(grad * act).sum(dim=1)))


def cam_fusion_cuda(act: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """The kernel: act, grad [B,C,h,w] contiguous CUDA tensors on one device,
    both float32, bfloat16 or float16 → [B,h,w] float32, launched on the current
    stream without synchronising, one cluster of ``cluster_size`` CTAs an
    image. Raises on anything the kernel does not take, and if the card
    cannot launch such clusters."""
    for name, t in (("act", act), ("grad", grad)):
        if t.device.type != "cuda":
            raise ValueError(f"cam_fusion_cuda needs CUDA tensors, {name} is on {t.device}")
        if t.dtype not in DTYPES:
            raise TypeError(f"cam_fusion_cuda takes float32, bfloat16 or float16, {name} is "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"cam_fusion_cuda needs contiguous tensors ({name} is not)")
    if act.dtype != grad.dtype:
        raise TypeError(f"cam_fusion_cuda takes act and grad of one dtype, got {act.dtype}, "
                        f"{grad.dtype}")
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
    S = cluster_size(B, C, sm_count(act.device))
    stream = stream_handle(act.device)
    with launch_device(act.device):
        err = lib.wsdl_cam_fusion(act.data_ptr(), grad.data_ptr(), out.data_ptr(), B, C,
                                  h * w, S, DTYPES[act.dtype], stream)
    if err != 0:
        raise RuntimeError(f"cam_fusion launch in clusters of {S} failed with cudaError {err}")
    cam_fusion_cuda.launches += 1
    cam_fusion_cuda.launches_by_dtype[str(act.dtype).removeprefix("torch.")] += 1
    return out


cam_fusion_cuda.launches = 0  # launches of the kernel since the last reset
# the same, by input type
cam_fusion_cuda.launches_by_dtype = {str(t).removeprefix("torch."): 0 for t in DTYPES}


def cam_fusion(act: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """The fusion of one layer, [B,C,h,w] × [B,C,h,w] → [B,h,w] float32: the
    kernel on CUDA tensors (bfloat16 or float16 ones of one type read as they
    are, any other as float32), the plain version on CPU tensors."""
    if act.is_cuda:
        if act.dtype != grad.dtype or act.dtype not in DTYPES:
            act, grad = act.float(), grad.float()
        return cam_fusion_cuda(act.contiguous(), grad.contiguous())
    return cam_fusion_plain(act, grad)
