"""Cross-entropy with the reference's reductions (port of
weaklysuperviseddl_tpu/losses/basic.py)."""

from __future__ import annotations

import torch


def per_example_nll(logits: torch.Tensor, labels: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Unreduced softmax negative log-likelihood, the class axis ``dim``
    contracted: the CE of the classifier step and of the segmentation step
    (both weight it by their padded-row valid masks)."""
    log_probs = torch.log_softmax(logits, dim=dim)
    return -log_probs.gather(dim, labels.long().unsqueeze(dim)).squeeze(dim)
