"""Connected-component labelling + largest-component filter (port of
weaklysuperviseddl_tpu/masks/components.py).

``label_components`` is the plain PyTorch version: the JAX package's fixed
point of a 3x3 neighbour min plus four segmented min-scans (rows and columns,
both directions), batched over B in one Python loop. On a CUDA tensor
``keep_largest_batch`` launches the hand-written kernel (``ops/cc.py``)
instead; both return the same labels: the linear index of each 8-connected
component's smallest pixel, -1 for background.

Largest-component selection is an offset histogram + ``argmax`` (the first
maximum, i.e. the smallest label, wins ties, as the JAX sort-based selection
does), with no host synchronisation, so the serving dispatch stays
asynchronous.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from weaklysuperviseddl_tpu_torch.ops.cc import label_components_cuda


def _neighbor_min(labels: torch.Tensor, fg: torch.Tensor, sentinel: int) -> torch.Tensor:
    """Min over the 3x3 neighbourhood (separable), masked to foreground."""
    pv = F.pad(labels, (0, 0, 1, 1), value=sentinel)
    v = torch.minimum(torch.minimum(pv[:, :-2], pv[:, 1:-1]), pv[:, 2:])
    ph = F.pad(v, (1, 1), value=sentinel)
    m = torch.minimum(torch.minimum(ph[..., :-2], ph[..., 1:-1]), ph[..., 2:])
    return torch.where(fg, m, sentinel)


def label_components(masks: torch.Tensor, max_iters: int | None = None) -> torch.Tensor:
    """Label 8-connected components of binary [H,W] or [B,H,W] masks.

    Returns int32 labels of the same shape: background -1, each component the
    linear index of its smallest pixel. ``max_iters`` bounds the fixed-point
    loop (default H+W), as in the JAX function.

    Segmented min-scans use ``torch.cummin`` with the run-offset trick: with
    BIG = H*W and run ids r (cumsum of background resets along the scan),
    ``cummin(v - BIG*r) + BIG*r`` is the min over the contiguous foreground
    run, since earlier runs are shifted up by at least BIG. Computed in int64.
    """
    squeeze = masks.ndim == 2
    if squeeze:
        masks = masks[None]
    B, H, W = masks.shape
    fg = masks != 0
    big = H * W
    seeds = torch.arange(H * W, dtype=torch.int64, device=masks.device).view(1, H, W)
    labels = torch.where(fg, seeds, big)
    limit = max_iters if max_iters is not None else H + W

    reset = (~fg).to(torch.int64)
    row_run = torch.cumsum(reset, dim=2) * big  # constant within each row run
    col_run = torch.cumsum(reset, dim=1) * big

    def seg_cummin(values, run_offset, dim, reverse):
        # scan-direction-"earlier" runs must rank strictly higher than any
        # in-run value: shift by -BIG*run_id forward, +BIG*run_id reverse
        sign = 1 if reverse else -1
        adj = torch.where(fg, values, big) + sign * run_offset
        if reverse:
            out = torch.cummin(adj.flip(dim), dim).values.flip(dim)
        else:
            out = torch.cummin(adj, dim).values
        out = out - sign * run_offset
        return torch.where(fg, out.clamp(max=big), big)

    it = 0
    while it < limit:
        new = _neighbor_min(labels, fg, big)
        new = seg_cummin(new, row_run, 2, False)
        new = seg_cummin(new, row_run, 2, True)
        new = seg_cummin(new, col_run, 1, False)
        new = seg_cummin(new, col_run, 1, True)
        it += 1
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            break
    out = torch.where(fg, labels, -1).to(torch.int32)
    return out[0] if squeeze else out


def largest_label(labels: torch.Tensor) -> torch.Tensor:
    """Most frequent nonnegative label of each [B,H,W] image → [B] int64.

    Counts in an H*W+1-bin histogram per image (background in the last bin,
    which never wins); ties go to the smallest label. An image with no
    foreground gets 0, which then selects nothing."""
    B = labels.shape[0]
    hw = labels[0].numel()
    flat = labels.reshape(B, hw).long()
    bins = torch.where(flat >= 0, flat, hw)
    counts = torch.zeros((B, hw + 1), dtype=torch.int32, device=labels.device)
    counts.scatter_add_(1, bins, torch.ones_like(bins, dtype=torch.int32))
    return counts[:, :hw].argmax(dim=1)


def _select_largest(labels: torch.Tensor) -> torch.Tensor:
    largest = largest_label(labels).view(-1, 1, 1)
    return ((labels == largest) & (labels >= 0)).to(torch.uint8)


def keep_largest(mask: torch.Tensor, max_iters: int | None = None) -> torch.Tensor:
    """Keep only the largest 8-connected component of one [H,W] mask (plain
    version). Empty masks stay empty; ties go to the smallest root index."""
    return _select_largest(label_components(mask[None], max_iters=max_iters))[0]


def keep_largest_batch(masks: torch.Tensor, max_iters: int | None = None,
                       backend: str = "auto") -> torch.Tensor:
    """Largest-component filter over [B,H,W] → uint8 {0,1} [B,H,W].

    backend="auto" launches the CUDA kernel on a CUDA tensor and uses the plain
    version on a CPU tensor; "kernel" and "plain" force one or the other
    ("kernel" raises on a CPU tensor). The kernel ignores ``max_iters``: it
    always reaches the fixed point.
    """
    if backend not in ("auto", "kernel", "plain"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "kernel" or (backend == "auto" and masks.is_cuda):
        if masks.dtype not in (torch.uint8, torch.bool):
            masks = (masks != 0).to(torch.uint8)
        labels = label_components_cuda(masks.contiguous())
    else:
        labels = label_components(masks, max_iters=max_iters)
    return _select_largest(labels)
