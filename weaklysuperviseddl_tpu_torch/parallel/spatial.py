"""The window losses and the refinement with the image split along H over a
mesh axis (port of weaklysuperviseddl_tpu/parallel/spatial.py).

Each rank holds rows [i·H/n, (i+1)·H/n) of every image (``shard_spatial``),
in the JAX layout ([B,H,W,C] predictions, [B,H,W,3] images):

  * ``exchange_halo`` extends the rows with ``pad`` rows of each neighbour,
    JAX's ``ppermute`` pair, as a ``batch_isend_irecv`` with the ranks above
    and below; the global top and bottom edges reflect the rank's own rows as
    the unsharded ``jnp.pad(mode="reflect")`` does. It is an autograd
    Function: the backward sends each halo's gradient back to the rank that
    owns those rows, which adds it to its edge rows (a ``ppermute``
    transposes to the reverse permutation);
  * the window sums run over the local rows (W is whole, reflect-padded
    locally), and JAX's ``psum``s are forward sums: each loss is the global
    one on every rank, and its gradient is that of this rank's terms
    (``_global_value``), so the ranks' gradients together are the unsharded
    gradient and none is counted twice.

The window sums are plain PyTorch on the card: JAX's sharded path is XLA
(``refine_from_soft_predictions_sharded`` drops ``use_pallas``), so no
kernel runs here.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from weaklysuperviseddl_tpu_torch.losses.window import affinity_exponent, window_offsets
from weaklysuperviseddl_tpu_torch.ops.refine import ADAM_B1, ADAM_B2, ADAM_EPS, _kl_per_image
from weaklysuperviseddl_tpu_torch.parallel.collectives import all_reduce_value


def _swap(up: torch.Tensor, down: torch.Tensor, group):
    """Send ``up`` to the rank above and ``down`` to the rank below (where
    they exist); returns (what the rank above sent down, what the rank below
    sent up), None at a global edge."""
    n, i = dist.get_world_size(group), dist.get_rank(group)
    ops, from_prev, from_next = [], None, None
    if i > 0:
        peer = dist.get_global_rank(group, i - 1)
        from_prev = torch.empty(down.shape, dtype=down.dtype, device=down.device)
        ops += [dist.P2POp(dist.isend, up.contiguous(), peer, group),
                dist.P2POp(dist.irecv, from_prev, peer, group)]
    if i < n - 1:
        peer = dist.get_global_rank(group, i + 1)
        from_next = torch.empty(up.shape, dtype=up.dtype, device=up.device)
        ops += [dist.P2POp(dist.isend, down.contiguous(), peer, group),
                dist.P2POp(dist.irecv, from_next, peer, group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return from_prev, from_next


class _ExchangeHalo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pad, group):
        n, i = dist.get_world_size(group), dist.get_rank(group)
        ctx.pad, ctx.group, ctx.edges = pad, group, (i == 0, i == n - 1)
        from_prev, from_next = _swap(x[:, :pad], x[:, -pad:], group)
        upper = x[:, 1:pad + 1].flip(1) if i == 0 else from_prev
        lower = x[:, -pad - 1:-1].flip(1) if i == n - 1 else from_next
        return torch.cat([upper, x, lower], dim=1)

    @staticmethod
    def backward(ctx, g):
        pad, (top, bottom) = ctx.pad, ctx.edges
        g_up, g_low = g[:, :pad], g[:, -pad:]
        g_x = g[:, pad:-pad].clone()
        from_prev, from_next = _swap(g_up, g_low, ctx.group)
        if top:
            g_x[:, 1:pad + 1] += g_up.flip(1)
        else:
            g_x[:, :pad] += from_prev
        if bottom:
            g_x[:, -pad - 1:-1] += g_low.flip(1)
        else:
            g_x[:, -pad:] += from_next
        return g_x, None, None


def exchange_halo(x: torch.Tensor, pad: int, group) -> torch.Tensor:
    """[B,Hl,W,C] local rows → [B,Hl+2·pad,W,C] with the neighbours' rows
    (reflected rows at the global edges); differentiable. Needs Hl > pad."""
    if x.shape[1] <= pad:
        raise ValueError(f"{x.shape[1]} rows a rank are too few for a halo of {pad}")
    return _ExchangeHalo.apply(x, pad, group)


def _global_value(local: torch.Tensor, group) -> torch.Tensor:
    """Σ over the group as the value, with the gradient of ``local`` alone."""
    return all_reduce_value(local, group) + (local - local.detach())


def _local_window_sums(probs_h, images_h, pad: int, window_size: int, sigma_color: float,
                       sigma_space: float | None) -> torch.Tensor:
    """Per image ([B]), Σ over the offsets, local rows, columns and classes
    of affinity · (p − p_shifted)²; ``probs_h`` and ``images_h`` carry the
    halo. W is reflect-padded here (it is not split)."""
    Hl, W = probs_h.shape[1] - 2 * pad, probs_h.shape[2]
    probs_p = F.pad(probs_h.permute(0, 3, 1, 2), (pad, pad, 0, 0), mode="reflect")
    img_p = F.pad(images_h.permute(0, 3, 1, 2), (pad, pad, 0, 0), mode="reflect")
    probs_c = probs_p[:, :, pad:pad + Hl, pad:pad + W]
    img_c = img_p[:, :, pad:pad + Hl, pad:pad + W]
    total = 0.0
    for dy, dx in window_offsets(window_size):
        sl = (slice(None), slice(None), slice(pad + dy, pad + dy + Hl),
              slice(pad + dx, pad + dx + W))
        d_img = img_c - img_p[sl]
        color_diff = (d_img[:, 0] * d_img[:, 0] + d_img[:, 1] * d_img[:, 1]
                      + d_img[:, 2] * d_img[:, 2])
        aff = torch.exp(affinity_exponent(color_diff, dy, dx, sigma_color, sigma_space))
        d = probs_c - probs_p[sl]
        total = total + (aff[:, None] * d * d).sum(dim=(1, 2, 3))
    return total


def _sharded_loss(probs, images, mesh, axis, sigma_color, sigma_space, window_size, per_class):
    B, Hl, W, C = probs.shape
    group = mesh.group(axis)
    pad = window_size // 2
    H = Hl * dist.get_world_size(group)
    denom = B * H * W * len(window_offsets(window_size)) * (C if per_class else 1)
    local = _local_window_sums(exchange_halo(probs, pad, group), exchange_halo(images, pad, group),
                               pad, window_size, sigma_color, sigma_space).sum()
    return _global_value(local, group) / denom


def spatial_sharded_ncut_loss(probs: torch.Tensor, images: torch.Tensor, mesh,
                              axis: str = "data", sigma_color: float = 0.05,
                              window_size: int = 5) -> torch.Tensor:
    """``losses/window.local_normalized_cut_loss`` of softmaxed input, from
    this rank's rows of ``probs`` [B,Hl,W,C] (probabilities: the caller
    softmaxes) and ``images`` [B,Hl,W,3]; the value is the whole image's."""
    return _sharded_loss(probs, images, mesh, axis, sigma_color, None, window_size, True)


def spatial_sharded_boundary_loss(probs: torch.Tensor, images: torch.Tensor, mesh,
                                  axis: str = "data", sigma_color: float = 0.1,
                                  sigma_space: float = 5.0,
                                  window_size: int = 5) -> torch.Tensor:
    """``losses/window.boundary_loss`` from this rank's rows, as
    ``spatial_sharded_ncut_loss``."""
    return _sharded_loss(probs, images, mesh, axis, sigma_color, sigma_space, window_size, False)


def refine_spatial_sharded(S: torch.Tensor, images: torch.Tensor, masks: torch.Tensor, mesh,
                           axis: str = "data", lambda_boundary: float = 0.1,
                           threshold: float = 0.5, lr: float = 1e-2, num_steps: int = 20,
                           sigma_color: float = 0.1, sigma_space: float = 5.0,
                           window_size: int = 5, loss: str = "ncut"):
    """``ops/refine.refine_plain`` with each image split along H: this
    rank's rows of S [B,Hl,W,C], the normalised images [B,Hl,W,3] and the
    masks [B,Hl,W]. Adam on X runs on the rank's rows; each step's KL and
    window terms are whole-image sums (so λ is each image's own), the window
    term exchanging halos. Returns (this rank's rows of the refined uint8
    masks, the mean over images of Σ_steps loss, the same on every rank)."""
    if loss not in ("ncut", "boundary"):
        raise ValueError(f"unknown refinement loss {loss!r}")
    B, Hl, W, C = S.shape
    group = mesh.group(axis)
    pad = window_size // 2
    H = Hl * dist.get_world_size(group)
    denom = H * W * len(window_offsets(window_size)) * (C if loss == "ncut" else 1)
    spatial = sigma_space if loss == "boundary" else None
    S, images = S.float(), images.float()
    images_h = exchange_halo(images, pad, group)
    x = F.one_hot(masks.long(), C).float()
    m = torch.zeros_like(x)
    v = torch.zeros_like(x)
    totals = torch.zeros(B, dtype=torch.float32, device=S.device)
    for t in range(num_steps):
        with torch.enable_grad():
            x.requires_grad_(True)
            q = torch.softmax(x, dim=-1)
            kl = _global_value(_kl_per_image(q, S), group)
            # the reference's double softmax: the ncut criterion softmaxes again
            inner = torch.softmax(q, dim=-1) if loss == "ncut" else q
            w = _global_value(_local_window_sums(exchange_halo(inner, pad, group), images_h, pad,
                                                 window_size, sigma_color, spatial), group) / denom
            lam = lambda_boundary * kl.detach() / (w.detach() + 1e-6)
            per_image = kl + lam * w
            (g,) = torch.autograd.grad(per_image.sum(), x)
        x = x.detach()
        totals = totals + per_image.detach()
        bc1 = 1.0 - ADAM_B1 ** (t + 1)
        bc2 = 1.0 - ADAM_B2 ** (t + 1)
        m = ADAM_B1 * m + (1.0 - ADAM_B1) * g
        v = ADAM_B2 * v + (1.0 - ADAM_B2) * (g * g)
        x = x - lr * ((m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS))
    refined = (torch.softmax(x, dim=-1)[..., 1] > threshold).to(torch.uint8)
    return refined, totals.mean()


def shard_spatial(mesh, x, axis: str = "data") -> torch.Tensor:
    """This rank's rows of a [B,H,...] array split along H on ``axis``, as a
    tensor on its device."""
    n, i = mesh.shape[axis], mesh.index(axis)
    x = torch.as_tensor(x)
    if x.shape[1] % n:
        raise ValueError(f"H={x.shape[1]} does not split over {n} ranks")
    share = x.shape[1] // n
    return x[:, i * share:(i + 1) * share].to(mesh.device)
