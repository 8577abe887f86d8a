"""Image resizing with the JAX package's semantics (weaklysuperviseddl_tpu/ops/resize.py).

* ``resize_bilinear``: half-pixel centres, ``F.interpolate(mode="bilinear",
  align_corners=False)``; with ``antialias=True`` it matches
  ``jax.image.resize(method="linear", antialias=True)`` when downsizing.
* ``resize_bicubic``: Keys cubic (a = -0.5). ``F.interpolate(mode="bicubic",
  antialias=True)`` uses that kernel and matches ``jax.image.resize(method="cubic")``
  whenever the kernel is not narrowed, i.e. with antialias or when upsizing.
  Downsizing without antialias runs the same kernel unscaled, as a separable
  weight matrix, since ``F.interpolate`` has no such mode (it uses a = -0.75).
* ``resize_nearest``: ``torch_legacy=True`` is ``F.interpolate(mode="nearest")``
  (``src = floor(dst * in/out)``); ``False`` uses half-pixel centres, as PIL's
  NEAREST does. Both as a gather.

All functions take [B,H,W,C], [H,W,C] or [H,W] tensors (``axes`` picks the
spatial axes of other layouts) and resize the spatial dims.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _spatial_axes(x: torch.Tensor, axes=None):
    """Rank-3 tensors are ambiguous ([H,W,C] vs [B,H,W]); pass ``axes`` to
    disambiguate. Defaults: rank2=[H,W], rank3=[H,W,C], rank4=[B,H,W,C]."""
    if axes is not None:
        return axes
    if x.ndim in (2, 3):
        return 0, 1
    if x.ndim == 4:
        return 1, 2
    raise ValueError(f"unsupported rank {x.ndim}")


def _as_nchw(x: torch.Tensor, axes):
    """Move the spatial axes last and fold the rest into channels: returns the
    [1, N, H, W] view in float32, or float64 for a float64 input, and a
    function that undoes the move."""
    h_ax, w_ax = _spatial_axes(x, axes)
    h_ax, w_ax = h_ax % x.ndim, w_ax % x.ndim
    perm = [d for d in range(x.ndim) if d not in (h_ax, w_ax)] + [h_ax, w_ax]
    inv = [perm.index(d) for d in range(x.ndim)]
    y = x.permute(perm)
    lead = y.shape[:-2]

    def back(z: torch.Tensor) -> torch.Tensor:
        return z.reshape(*lead, *z.shape[-2:]).permute(inv)

    y = y.reshape(1, -1, *y.shape[-2:])
    return y.to(torch.promote_types(y.dtype, torch.float32)), back


def _restore_dtype(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    # floating inputs keep their dtype; integer inputs come back as float32
    return y.to(x.dtype) if x.is_floating_point() else y


def resize_bilinear(x: torch.Tensor, size: tuple[int, int], antialias: bool = False,
                    axes=None) -> torch.Tensor:
    """Bilinear, half-pixel centres (torch ``align_corners=False``)."""
    y, back = _as_nchw(x, axes)
    y = F.interpolate(y, size=tuple(size), mode="bilinear", align_corners=False,
                      antialias=antialias)
    return _restore_dtype(back(y), x)


def _keys_cubic(d: torch.Tensor) -> torch.Tensor:
    d = d.abs()
    near = ((1.5 * d - 2.5) * d) * d + 1.0
    far = ((-0.5 * d + 2.5) * d - 4.0) * d + 2.0
    return torch.where(d >= 2.0, torch.zeros_like(d), torch.where(d >= 1.0, far, near))


def _cubic_weights(in_n: int, out_n: int) -> torch.Tensor:
    """[out_n, in_n] weights of an unscaled Keys cubic at half-pixel centres,
    renormalised over the taps that fall inside the input (jax.image's rule)."""
    centre = (torch.arange(out_n, dtype=torch.float32) + 0.5) * (in_n / out_n) - 0.5
    w = _keys_cubic(centre[:, None] - torch.arange(in_n, dtype=torch.float32)[None, :])
    total = w.sum(1, keepdim=True)
    return torch.where(total.abs() > 1000 * torch.finfo(torch.float32).eps,
                       w / total, torch.zeros_like(w))


def resize_bicubic(x: torch.Tensor, size: tuple[int, int], antialias: bool = True,
                   axes=None) -> torch.Tensor:
    """Bicubic (Keys, a = -0.5); antialias=True approximates PIL BICUBIC."""
    y, back = _as_nchw(x, axes)
    (in_h, in_w), (out_h, out_w) = y.shape[-2:], size
    if antialias or (out_h >= in_h and out_w >= in_w):
        y = F.interpolate(y, size=(out_h, out_w), mode="bicubic", align_corners=False,
                          antialias=True)
    else:
        wh = _cubic_weights(in_h, out_h).to(y.device, y.dtype)
        ww = _cubic_weights(in_w, out_w).to(y.device, y.dtype)
        y = torch.einsum("oh,nchw,pw->ncop", wh, y, ww)
    return _restore_dtype(back(y), x)


def resize_nearest(x: torch.Tensor, size: tuple[int, int], torch_legacy: bool = True,
                   axes=None) -> torch.Tensor:
    """Nearest-neighbour resize as a gather (keeps the input dtype).

    torch_legacy=True reproduces ``F.interpolate(mode='nearest')``:
    ``src_idx = floor(dst_idx * in/out)``; False uses half-pixel centres
    (``floor((dst_idx + 0.5) * in/out)``).
    """
    h_ax, w_ax = _spatial_axes(x, axes)

    def src_idx(out_n, in_n):
        i = torch.arange(out_n, dtype=torch.float32, device=x.device)
        scale = in_n / out_n
        idx = torch.floor(i * scale) if torch_legacy else torch.floor((i + 0.5) * scale)
        return idx.long().clamp(0, in_n - 1)

    y = x.index_select(h_ax, src_idx(size[0], x.shape[h_ax]))
    return y.index_select(w_ax, src_idx(size[1], x.shape[w_ax]))
