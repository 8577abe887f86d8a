"""Window-affinity losses (port of weaklysuperviseddl_tpu/losses/window.py).

Plain PyTorch, autograd-able: they are the golden of the refinement kernel's
plain version (``ops/refine.py``).

  * ``local_normalized_cut_loss``: per offset (dy,dx) of a win×win window
    (centre excluded), colour affinity ``exp(-‖I−I_shift‖²/(2σ_c²))`` times the
    per-class ``(S_c−S_c,shift)²``, a mean per class per offset, summed, over
    ``count·C``. Softmaxes its input first, as the reference does.
  * ``boundary_loss``: the affinity adds ``−(dx²+dy²)/(2σ_s²)``; the class
    difference is summed over classes before weighting; mean over offsets.

Both reflect-pad (``jnp.pad(mode="reflect")``: the edge is not repeated), as
does ``window_affinities``, the boundary loss's affinity map of every offset.
Layouts are the JAX package's: [B,H,W,C] predictions, [B,H,W,3] images. The
``*_per_image`` forms return one value per image ([B]), which is what the
refinement needs (its λ is per image); the public functions average them over
the batch, as the JAX functions' batch means do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def window_offsets(window_size: int) -> list[tuple[int, int]]:
    """The win²−1 offsets (dy, dx) of the window, row-major, centre excluded."""
    pad = window_size // 2
    return [(dy, dx) for dy in range(-pad, pad + 1) for dx in range(-pad, pad + 1)
            if not (dy == 0 and dx == 0)]


def _reflect_nchw(x: torch.Tensor, pad: int) -> torch.Tensor:
    """[B,H,W,C] → reflect-padded [B,C,H+2p,W+2p]."""
    return F.pad(x.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode="reflect")


def affinity_exponent(color_diff: torch.Tensor, dy: int, dx: int, sigma_color: float,
                      sigma_space: float | None) -> torch.Tensor:
    """The exponent of one offset's affinity. One formula (the same float
    constants, the same order) for the plain refinement and the CUDA kernel."""
    inv2sc = 1.0 / (2.0 * sigma_color ** 2)
    expo = -(color_diff * inv2sc)
    if sigma_space is not None:
        expo = expo - (dy * dy + dx * dx) / (2.0 * sigma_space ** 2)
    return expo


def _affinities(images: torch.Tensor, window_size: int, sigma_color: float,
                sigma_space: float | None):
    """Yields the affinity [B,H,W] of each offset, in ``window_offsets`` order."""
    _, H, W, _ = images.shape
    pad = window_size // 2
    img_p = _reflect_nchw(images, pad)
    img_c = img_p[:, :, pad:pad + H, pad:pad + W]
    for dy, dx in window_offsets(window_size):
        d_img = img_c - img_p[:, :, pad + dy:pad + dy + H, pad + dx:pad + dx + W]
        color_diff = (d_img[:, 0] * d_img[:, 0] + d_img[:, 1] * d_img[:, 1]
                      + d_img[:, 2] * d_img[:, 2])
        yield torch.exp(affinity_exponent(color_diff, dy, dx, sigma_color, sigma_space))


def _window_terms(probs: torch.Tensor, images: torch.Tensor, window_size: int,
                  sigma_color: float, sigma_space: float | None):
    """Yields (affinity [B,H,W], squared class differences [B,C,H,W]) per offset."""
    _, H, W, _ = probs.shape
    pad = window_size // 2
    probs_p = _reflect_nchw(probs, pad)
    probs_c = probs_p[:, :, pad:pad + H, pad:pad + W]
    affs = _affinities(images, window_size, sigma_color, sigma_space)
    for (dy, dx), aff in zip(window_offsets(window_size), affs):
        d = probs_c - probs_p[:, :, pad + dy:pad + dy + H, pad + dx:pad + dx + W]
        yield aff, d * d


def window_affinities(images: torch.Tensor, sigma_color: float = 0.1, sigma_space: float = 5.0,
                      window_size: int = 5) -> torch.Tensor:
    """[B,H,W,3] images → the affinity maps [B,K,H,W] of the K = win²−1
    offsets in ``window_offsets`` order, colour and spatial terms together
    (ref compute_affinities, AlternatingDirectionCutLoss.py:612-637)."""
    return torch.stack(list(_affinities(images, window_size, sigma_color, sigma_space)), dim=1)


def local_normalized_cut_per_image(preds: torch.Tensor, images: torch.Tensor,
                                   sigma_color: float = 0.05,
                                   window_size: int = 5) -> torch.Tensor:
    """[B,H,W,C] logits, [B,H,W,3] images → [B]: the loss of each image alone."""
    C = preds.shape[-1]
    probs = torch.softmax(preds, dim=-1)
    K = len(window_offsets(window_size))
    loss = 0.0
    for aff, diff2 in _window_terms(probs, images, window_size, sigma_color, None):
        loss = loss + (aff[:, None] * diff2).mean(dim=(2, 3)).sum(dim=1)
    return loss / (K * C)


def local_normalized_cut_loss(preds: torch.Tensor, images: torch.Tensor,
                              sigma_color: float = 0.05,
                              window_size: int = 5) -> torch.Tensor:
    """Exact reference semantics (AlternatingDirectionCutLoss.py:71-105)."""
    return local_normalized_cut_per_image(preds, images, sigma_color, window_size).mean()


def boundary_per_image(probs: torch.Tensor, images: torch.Tensor, sigma_color: float = 0.1,
                       sigma_space: float = 5.0, window_size: int = 5) -> torch.Tensor:
    """[B,H,W,C] probabilities, [B,H,W,3] images → [B]."""
    K = len(window_offsets(window_size))
    loss = 0.0
    for aff, diff2 in _window_terms(probs, images, window_size, sigma_color, sigma_space):
        loss = loss + (aff * diff2.sum(dim=1)).mean(dim=(1, 2))
    return loss / K


def boundary_loss(probs: torch.Tensor, images: torch.Tensor, sigma_color: float = 0.1,
                  sigma_space: float = 5.0, window_size: int = 5) -> torch.Tensor:
    """ConstrainToBoundary loss, batched (ref AlternatingDirectionBoundaryLoss.py:20-44)."""
    return boundary_per_image(probs, images, sigma_color, sigma_space, window_size).mean()
