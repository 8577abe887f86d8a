"""Cross-entropy and KL with the reference's reductions (port of
weaklysuperviseddl_tpu/losses/basic.py)."""

from __future__ import annotations

import torch


def per_example_nll(logits: torch.Tensor, labels: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Unreduced softmax negative log-likelihood, the class axis ``dim``
    contracted: the CE of the classifier step and of the segmentation step
    (both weight it by their padded-row valid masks)."""
    log_probs = torch.log_softmax(logits, dim=dim)
    return -log_probs.gather(dim, labels.long().unsqueeze(dim)).squeeze(dim)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Mean softmax cross-entropy over every non-class position: torch's
    ``nn.CrossEntropyLoss()`` default (ref SegmentationModel.py:90), with the
    class axis ``dim`` (-1 for the JAX package's [B,H,W,C] logits)."""
    return per_example_nll(logits, labels, dim).mean()


def kl_div_batchmean(log_q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``F.kl_div(log_q, p, reduction="batchmean")``: Σ p·(log p − log q) over
    the batch size, with p·log p = 0 where p = 0 (ref
    AlternatingDirectionCutLoss.py:742)."""
    p_log_p = torch.where(p > 0, p * torch.log(torch.where(p > 0, p, torch.ones_like(p))),
                          torch.zeros_like(p))
    return (p_log_p - p * log_q).sum() / log_q.shape[0]
