"""Batched image preprocessing (port of weaklysuperviseddl_tpu/data/preprocess.py).

uint8 → float/255 → resize → clip → optional ImageNet normalisation, on
whatever device the images are on. ``preprocess_batch`` keeps the JAX layout
([B,H,W,3] in and out); ``preprocess_images`` is the NCHW form the serving
path uses inside.
"""

from __future__ import annotations

import torch

from weaklysuperviseddl_tpu_torch.ops.resize import (
    resize_bicubic,
    resize_bilinear,
    resize_nearest,
)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_images(x: torch.Tensor, channel_dim: int = -1) -> torch.Tensor:
    """ImageNet normalisation of float images along ``channel_dim``."""
    shape = [1] * x.ndim
    shape[channel_dim] = 3
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device).view(shape)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device).view(shape)
    return (x - mean) / std


def preprocess_images(images: torch.Tensor, size: int, interpolation: str = "bilinear",
                      normalize: bool = False) -> torch.Tensor:
    """[B,3,H,W] uint8 or float → [B,3,size,size] float32 in [0,1] (or
    normalised). Downsizing with bilinear interpolation antialiases, as the
    JAX package does (``antialias = H > size``)."""
    if images.is_floating_point():
        x = images.float()
    else:
        # the correctly rounded float32 quotient on every device: CUDA divides
        # by a host scalar as a multiply by its reciprocal, which in float32
        # is 1 ulp off for 126 of the 256 values; in float64 it is not
        x = (images.double() / 255.0).float()
    if x.shape[-2] != size or x.shape[-1] != size:
        if interpolation == "bicubic":
            x = resize_bicubic(x, (size, size), axes=(2, 3))
        else:
            x = resize_bilinear(x, (size, size), antialias=x.shape[-2] > size,
                                axes=(2, 3))
    x = x.clamp(0.0, 1.0)
    if normalize:
        x = normalize_images(x, channel_dim=1)
    return x


def preprocess_batch(
    images: torch.Tensor,           # [B,H,W,3] uint8 or float
    trimaps: torch.Tensor | None,   # [B,H,W] uint8 (Pet: 1=fg, 2=bg, 3=boundary)
    size: int = 224,
    interpolation: str = "bilinear",
    normalize: bool = False,
    shift_mask_labels: bool = True,
    binarize_fg: bool = False,
):
    """Batched preprocessing in the JAX layout: returns ([B,size,size,3] float32,
    [B,size,size] int32 trimaps or None).

    * image: as ``preprocess_images``.
    * trimap: nearest resize with half-pixel centres, then optionally
      ``clamp(t - 1, 0)`` (0=fg, 1=bg, 2=boundary) or binarise to ``t == 1``.
    """
    x = preprocess_images(images.permute(0, 3, 1, 2), size, interpolation, normalize)
    x = x.permute(0, 2, 3, 1)

    t = None
    if trimaps is not None:
        t = trimaps
        if t.shape[1] != size or t.shape[2] != size:
            t = resize_nearest(t, (size, size), torch_legacy=False, axes=(1, 2))
        t = t.to(torch.int32)
        if shift_mask_labels:
            t = (t - 1).clamp(min=0)
        if binarize_fg:
            t = (t == 1).to(torch.int32)
    return x, t
