"""Lovász losses (port of weaklysuperviseddl_tpu/losses/lovasz.py; semantics of
the reference's vendored TraditionalModel/LossFunctions/Lovasz-Softmax_Loss.py).

The Lovász extension of the Jaccard index: per class, sort the absolute
errors in descending order and take their dot product with the discrete IoU
subgradient, computed by cumulative sums over the ground truth sorted the
same way. As in the JAX package, the reference's dynamic shapes become
fixed-shape masked sums: ignored pixels get foreground 0 and error 0, so they
sort to the tail and add nothing; with ``classes="present"`` absent classes
get weight 0 in the class mean. The sort is stable (``torch.sort(...,
stable=True)``), as JAX's ``sort_key_val`` is, so tied errors keep their
order and both packages pair them with the same ground truth.
"""

from __future__ import annotations

import torch


def lovasz_grad(gt_sorted: torch.Tensor) -> torch.Tensor:
    """Jaccard subgradient w.r.t. the sorted errors, along the last dim (ref
    Lovasz-Softmax_Loss.py:11-23)."""
    p = gt_sorted.shape[-1]
    gts = gt_sorted.sum(dim=-1, keepdim=True)
    intersection = gts - torch.cumsum(gt_sorted, dim=-1)
    union = gts + torch.cumsum(1.0 - gt_sorted, dim=-1)
    jaccard = 1.0 - intersection / union
    if p > 1:
        jaccard = torch.cat([jaccard[..., :1], jaccard[..., 1:] - jaccard[..., :-1]], dim=-1)
    return jaccard


def _sorted_dot(errors: torch.Tensor, fg: torch.Tensor) -> torch.Tensor:
    """Σ sorted errors · lovasz_grad(fg in the same order), along the last dim."""
    errors_sorted, perm = torch.sort(errors, dim=-1, descending=True, stable=True)
    return (errors_sorted * lovasz_grad(torch.gather(fg, -1, perm))).sum(dim=-1)


def _lovasz_softmax_flat(probas, labels, valid, class_ids, present_only):
    """probas [N,P,C], labels [N,P] integer, valid [N,P] bool → [N]."""
    losses, weights = [], []
    vf = valid.to(probas.dtype)
    for c in class_ids:
        fg = ((labels == c) & valid).to(probas.dtype)
        diff = fg - probas[..., c]
        # |diff| with JAX's derivative at 0 (+1; torch's abs has 0 there): a
        # prediction that is exactly right keeps its share of the subgradient
        errors = torch.where(diff >= 0, diff, -diff) * vf
        losses.append(_sorted_dot(errors, fg))
        weights.append((fg.sum(dim=-1) > 0).to(probas.dtype) if present_only
                       else torch.ones_like(losses[-1]))
    losses = torch.stack(losses, dim=-1)
    weights = torch.stack(weights, dim=-1)
    return (losses * weights).sum(dim=-1) / weights.sum(dim=-1).clamp(min=1e-8)


def _class_ids(classes, C: int):
    if isinstance(classes, str):
        if classes not in ("present", "all"):
            raise ValueError(f"classes must be 'present', 'all' or a tuple, got {classes!r}")
        return tuple(range(C)), classes == "present"
    return tuple(classes), False


def _flatten(probas, labels, ignore):
    B, H, W, C = probas.shape
    flat_l = labels.reshape(B, H * W).long()
    valid = torch.ones_like(flat_l, dtype=torch.bool) if ignore is None else flat_l != ignore
    return probas.reshape(B, H * W, C), flat_l, valid


def lovasz_softmax_per_image(probas: torch.Tensor, labels: torch.Tensor,
                             classes="present", ignore: int | None = None) -> torch.Tensor:
    """The loss of each image, [B]: probas [B,H,W,C] probabilities, labels
    [B,H,W] integer."""
    class_ids, present_only = _class_ids(classes, probas.shape[-1])
    flat_p, flat_l, valid = _flatten(probas, labels, ignore)
    return _lovasz_softmax_flat(flat_p, flat_l, valid, class_ids, present_only)


def lovasz_softmax(probas: torch.Tensor, labels: torch.Tensor, classes="present",
                   per_image: bool = False, ignore: int | None = None) -> torch.Tensor:
    """Multi-class Lovász-Softmax (ref Lovasz-Softmax_Loss.py:146-192): probas
    [B,H,W,C] (NHWC, as the JAX package; the reference is NCHW), labels
    [B,H,W]. ``per_image``: the mean of each image's loss; else one loss over
    all pixels of the batch."""
    if per_image:
        return lovasz_softmax_per_image(probas, labels, classes, ignore).mean()
    class_ids, present_only = _class_ids(classes, probas.shape[-1])
    flat_p, flat_l, valid = _flatten(probas, labels, ignore)
    C = flat_p.shape[-1]
    return _lovasz_softmax_flat(flat_p.reshape(1, -1, C), flat_l.reshape(1, -1),
                                valid.reshape(1, -1), class_ids, present_only)[0]


def _lovasz_hinge_flat(logits, labels, valid):
    """logits, labels, valid [N,P] float → [N]."""
    signs = 2.0 * labels - 1.0
    # hinge errors can be negative: ignored pixels are forced below every valid
    # one, or they would interleave mid-sort; relu then zeroes them
    errors = torch.where(valid > 0, 1.0 - logits * signs, torch.full_like(logits, -1e9))
    errors_sorted, perm = torch.sort(errors, dim=-1, descending=True, stable=True)
    grad = lovasz_grad(torch.gather(labels * valid, -1, perm))
    return (torch.relu(errors_sorted) * grad).sum(dim=-1)


def lovasz_hinge(logits: torch.Tensor, labels: torch.Tensor, per_image: bool = True,
                 ignore: int | None = None) -> torch.Tensor:
    """Binary Lovász hinge (ref Lovasz-Softmax_Loss.py:71-104): logits and
    binary labels [B,H,W]."""
    B = logits.shape[0]
    flat_lg = logits.reshape(B, -1)
    flat_lb = labels.reshape(B, -1).to(logits.dtype)
    valid = (torch.ones_like(flat_lb) if ignore is None
             else (flat_lb != ignore).to(logits.dtype))
    if per_image:
        return _lovasz_hinge_flat(flat_lg, flat_lb, valid).mean()
    return _lovasz_hinge_flat(flat_lg.reshape(1, -1), flat_lb.reshape(1, -1),
                              valid.reshape(1, -1))[0]


def stable_bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable BCE with logits (ref StableBCELoss, :122-128)."""
    loss = logits.clamp(min=0.0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    return loss.mean()
