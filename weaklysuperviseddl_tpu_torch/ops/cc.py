"""Connected-component labelling on the card: the wrapper of ``csrc/cc.cu``.

Port of the TPU kernel ``weaklysuperviseddl_tpu/ops/pallas_cc.py::_cc_kernel``
(``pallas_label_components_batch``): [B,H,W] binary masks → int32 labels, each
the linear index of its 8-connected component's smallest pixel, -1 for
background. The CUDA kernel is a union-find over 2x2 pixel blocks (see the note
at the top of ``csrc/cc.cu``) in one of two plans, chosen by shape before the
launch (``plan_for``): ``"image"``, one block an image with the whole image's
union-find in shared memory, where its nodes fit; else ``"tiles"``, a
block-based union-find in three launches. Both always compute the true fixed
point, where the JAX functions stop after ``max_iters`` rounds.

The kernel is built with ``nvcc`` at first use (``ops/build.py``) and loaded
with ``ctypes``. The plain PyTorch version of the same function is
``masks/components.label_components``.
"""

from __future__ import annotations

import ctypes

import torch

from weaklysuperviseddl_tpu_torch.ops.build import build, launch_device, stream_handle

SOURCE = "cc.cu"
PLANS = ("image", "tiles")          # csrc/cc.cu's PLAN_IMAGE and PLAN_TILES
SMEM_LIMIT = 232448                 # dynamic shared memory one block may opt into (sm_90)
LINK_BUFFERS = 4 * 64 * 32          # csrc/cc.cu: LINKS ints for each of a block's 32 warps

_lib = None


def image_plan_bytes(H: int, W: int) -> int:
    """Shared bytes the "image" plan takes for an H x W image: five bit
    planes of 32-node words over the 2x2 nodes, an int32 a node (and one of
    padding every 32), and the warps' link buffers."""
    rows, R = -(-H // 2), -(-W // 2)
    return 5 * 4 * rows * -(-R // 32) + 4 * (rows * R + rows * R // 32) + LINK_BUFFERS


def plan_for(H: int, W: int) -> str:
    """The plan an H x W image takes: "image" where its union-find fits one
    block's shared memory (up to 432 x 432), else "tiles"."""
    return "image" if image_plan_bytes(H, W) <= SMEM_LIMIT else "tiles"


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build(SOURCE)))
        lib.wsdl_cc_label.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
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
    plan = plan_for(H, W)
    lib = _load()
    stream = stream_handle(masks.device)
    with launch_device(masks.device):
        err = lib.wsdl_cc_label(masks.data_ptr(), labels.data_ptr(), B, H, W, PLANS.index(plan),
                                stream)
    if err != 0:
        raise RuntimeError(f"cc_label launch failed with cudaError {err}")
    label_components_cuda.launches += 1
    label_components_cuda.plan_launches[plan] += 1
    return labels


label_components_cuda.launches = 0  # launches of the kernel since the last reset
label_components_cuda.plan_launches = dict.fromkeys(PLANS, 0)  # the same, by plan
