"""Image resizing with the JAX package's semantics (weaklysuperviseddl_tpu/ops/resize.py).

* ``resize_bilinear``: half-pixel centres, ``F.interpolate(mode="bilinear",
  align_corners=False)``; with ``antialias=True`` it matches
  ``jax.image.resize(method="linear", antialias=True)`` when downsizing.
* ``resize_bicubic``: Keys cubic (a = -0.5). ``F.interpolate(mode="bicubic",
  antialias=True)`` uses that kernel and matches ``jax.image.resize(method="cubic")``
  whenever the kernel is not narrowed, i.e. with antialias or when upsizing.
  Downsizing without antialias runs the same kernel unscaled, as a separable
  weight matrix, since ``F.interpolate`` has no such mode (it uses a = -0.75).
* ``upsample_bilinear``: ``F.interpolate(mode="bilinear",
  align_corners=False)`` on NCHW, whose backward on the card is the adjoint
  as two products with the interpolation's weight matrices in float64, in a
  fixed order, where CUDA's own backward adds with atomics and so parts
  from itself between runs.
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


def _bilinear_weights(in_n: int, out_n: int, device, dtype) -> torch.Tensor:
    """[out_n, in_n] float64 weights of ``F.interpolate``'s bilinear rule
    (align_corners=False, size given) for inputs of ``dtype``: source
    ``max((o + 0.5)·in/out − 0.5, 0)`` in torch's accumulate type (float64
    for float64, else float32), its floor and the next index (the last one
    twice at the edge) weighted 1 − λ and λ."""
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    # in/out divided on the device: no host copy (it may run inside a capture)
    scale = (torch.full((), in_n, dtype=acc, device=device)
             / torch.full((), out_n, dtype=acc, device=device))
    src = ((torch.arange(out_n, dtype=acc, device=device) + 0.5) * scale - 0.5).clamp(min=0)
    i0 = src.long()
    i1 = (i0 + 1).clamp(max=in_n - 1)
    lam = src - i0
    w = torch.zeros(out_n, in_n, dtype=torch.float64, device=device)
    w.scatter_add_(1, i0[:, None], (1.0 - lam).double()[:, None])
    w.scatter_add_(1, i1[:, None], lam.double()[:, None])
    return w


class _UpsampleBilinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, size):
        ctx.in_size = tuple(x.shape[-2:])
        return F.interpolate(x, size=size, mode="bilinear", align_corners=False)

    @staticmethod
    def backward(ctx, g):
        (in_h, in_w), (out_h, out_w) = ctx.in_size, g.shape[-2:]
        wh = _bilinear_weights(in_h, out_h, g.device, g.dtype)
        ww = _bilinear_weights(in_w, out_w, g.device, g.dtype)
        return (wh.t() @ (g.double() @ ww)).to(g.dtype), None


def upsample_bilinear(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """[B,C,h,w] → [B,C,H,W] bilinear, half-pixel centres: ``F.interpolate``'s
    values. Its gradient on the card is the same adjoint computed without
    atomics (a float64 product with each axis's weight matrix), so a training
    step gives the same bits in every run and in a captured graph; on the CPU
    torch's own backward, which is already deterministic."""
    size = tuple(size)
    if x.is_cuda and torch.is_grad_enabled() and x.requires_grad:
        return _UpsampleBilinear.apply(x, size)
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False)


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
