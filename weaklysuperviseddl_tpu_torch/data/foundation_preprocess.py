"""The foundation models' image processors as torch code, on the image's device.

``transformers``' slow processors, which the JAX package calls, resize
through PIL on uint8 images (``image_transforms.py:374-377``, BILINEAR for
both models). PIL's bilinear filter widens its support by the scale when it
shrinks an image, runs a horizontal pass then a vertical pass with 22-bit
fixed-point coefficients, and rounds to uint8 after each pass
(``libImaging/Resample.c``). ``pil_bilinear_resize`` rebuilds that in
integer torch arithmetic, so the ``pixel_values`` here equal the processors'
to the bit. Rescaling multiplies in float64 and rounds to float32, and
normalisation runs in float32, as the processors' numpy does.

- ``sam_preprocess``: longest edge to ``longest_edge``, rescale, ImageNet
  mean/std, zero padding at the bottom and right to ``pad_size``², boxes
  rescaled to the resized frame in float64 (``image_processing_sam.py``,
  ``processing_sam.py``).
- ``gdino_preprocess``: shortest/longest edge under
  ``get_size_with_aspect_ratio`` (``image_processing_grounding_dino.py:99``),
  rescale, ImageNet mean/std, and the pixel mask of a batch of one.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
_PRECISION_BITS = 32 - 8 - 2


def _pil_coeffs(in_size: int, out_size: int):
    """PIL's ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for the
    bilinear filter: (first source index [out], fixed-point weights [out, k])."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    starts = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = []
        for x in range(xmax):
            t = abs((x + xmin - center + 0.5) * ss)
            k.append(1.0 - t if t < 1.0 else 0.0)
        ww = sum(k)
        if ww != 0.0:
            k = [w / ww for w in k]
        starts[xx] = xmin
        for x, w in enumerate(k):
            f = w * (1 << _PRECISION_BITS)
            weights[xx, x] = int(-0.5 + f) if w < 0 else int(0.5 + f)
    return starts, weights


@functools.lru_cache(maxsize=64)
def _pass_tables(in_size: int, out_size: int, device: torch.device):
    """``_pil_coeffs`` as device tensors: (source indices [out, k], clamped
    to the image, fixed-point weights [out, k]), built once per sizes and device."""
    starts, weights = _pil_coeffs(in_size, out_size)
    idx = np.minimum(starts[:, None] + np.arange(weights.shape[1])[None, :], in_size - 1)
    return torch.from_numpy(idx).to(device), torch.from_numpy(weights).to(device)


def _resample_pass(x: torch.Tensor, out_size: int, dim: int) -> torch.Tensor:
    """One PIL pass along ``dim`` of an int64 [H, W, C] tensor of 0-255 values."""
    idx, w = _pass_tables(x.shape[dim], out_size, x.device)
    k = w.shape[1]
    g = x.index_select(dim, idx.reshape(-1))
    shape = list(x.shape)
    shape[dim:dim + 1] = [out_size, k]
    g = g.reshape(shape)
    wshape = [1] * g.dim()
    wshape[dim], wshape[dim + 1] = out_size, k
    acc = (g * w.reshape(wshape)).sum(dim + 1) + (1 << (_PRECISION_BITS - 1))
    return torch.clamp(acc >> _PRECISION_BITS, 0, 255)


def pil_bilinear_resize(image: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """uint8 [H, W, C] → uint8 [h, w, C], bit-equal to PIL's
    ``Image.resize((w, h), BILINEAR)``."""
    h, w = size
    x = image.to(torch.int64)
    if w != x.shape[1]:
        x = _resample_pass(x, w, 1)
    if h != x.shape[0]:
        x = _resample_pass(x, h, 0)
    return x.to(torch.uint8)


def as_image_tensor(image, device) -> torch.Tensor:
    """A PIL image, HWC numpy array (cast to uint8, as the JAX package's
    ``_as_pil`` casts) or uint8 tensor → uint8 [H, W, 3] on ``device``."""
    if not isinstance(image, torch.Tensor):
        image = torch.from_numpy(np.ascontiguousarray(np.asarray(image).astype(np.uint8)))
    if image.dtype != torch.uint8 or image.dim() != 3 or image.shape[-1] != 3:
        raise ValueError(f"an image is uint8 [H, W, 3], got {image.dtype} {tuple(image.shape)}")
    return image.to(device)


def _normalize(image: torch.Tensor) -> torch.Tensor:
    """uint8 [H, W, 3] → float32 [3, H, W]: ×(1/255) in float64, then
    (x − mean) / std in float32."""
    x = (image.to(torch.float64) * (1 / 255)).to(torch.float32)
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return ((x - mean) / std).permute(2, 0, 1)


def sam_resized_shape(height: int, width: int, longest_edge: int) -> tuple[int, int]:
    scale = longest_edge * 1.0 / max(height, width)
    return int(height * scale + 0.5), int(width * scale + 0.5)


def sam_preprocess(image, boxes, longest_edge: int = 1024, pad_size: int = 1024, device="cpu"):
    """(pixel_values [1, 3, pad, pad] float32, input_boxes [1, N, 4] float64)."""
    img = as_image_tensor(image, device)
    H, W = img.shape[:2]
    h, w = sam_resized_shape(H, W, longest_edge)
    x = _normalize(pil_bilinear_resize(img, (h, w)))
    x = torch.nn.functional.pad(x, (0, pad_size - w, 0, pad_size - h))
    b = torch.as_tensor(np.asarray(boxes, np.float32).reshape(-1, 4), device=device)
    b = b.to(torch.float64).reshape(-1, 2, 2)
    b = torch.stack([b[..., 0] * (w / W), b[..., 1] * (h / H)], dim=-1).reshape(1, -1, 4)
    return x[None], b


def gdino_size(height: int, width: int, shortest_edge: int, longest_edge: int) -> tuple[int, int]:
    """``get_size_with_aspect_ratio`` (image_processing_grounding_dino.py:99)."""
    size, raw = shortest_edge, None
    lo, hi = float(min(height, width)), float(max(height, width))
    if hi / lo * size > longest_edge:
        raw = longest_edge * lo / hi
        size = int(round(raw))
    if (height <= width and height == size) or (width <= height and width == size):
        return height, width
    if width < height:
        return (int(raw * height / width) if raw is not None else int(size * height / width)), size
    return size, (int(raw * width / height) if raw is not None else int(size * width / height))


def gdino_preprocess(image, shortest_edge: int = 800, longest_edge: int = 1333, device="cpu"):
    """(pixel_values [1, 3, h, w] float32, pixel_mask [1, h, w] int64)."""
    img = as_image_tensor(image, device)
    h, w = gdino_size(img.shape[0], img.shape[1], shortest_edge, longest_edge)
    x = _normalize(pil_bilinear_resize(img, (h, w)))[None]
    return x, torch.ones((1, h, w), dtype=torch.int64, device=device)
