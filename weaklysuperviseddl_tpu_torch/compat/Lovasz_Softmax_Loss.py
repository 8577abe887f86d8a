"""Reference surface: TraditionalModel/LossFunctions/Lovasz-Softmax_Loss.py,
the module name made importable (port of
weaklysuperviseddl_tpu/compat/Lovasz_Softmax_Loss.py).

Every public name of the reference, over ``losses/lovasz.py``; probabilities
and logits are NCHW as the reference takes them. Losses are tensors on the
inputs' device; the flatten helpers and the IoUs are numpy, as in the JAX
package.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from weaklysuperviseddl_tpu_torch.compat._adapt import to_array, to_numpy
from weaklysuperviseddl_tpu_torch.losses import lovasz as _lovasz
from weaklysuperviseddl_tpu_torch.losses.basic import per_example_nll

lovasz_grad = _lovasz.lovasz_grad


def _classes(classes):
    return classes if isinstance(classes, str) else tuple(classes)


def _nhwc_probas(probas) -> torch.Tensor:
    """NCHW probabilities → NHWC; a [B,H,W] sigmoid output → [B,H,W,1]."""
    p = to_array(probas)
    return p[..., None] if p.ndim == 3 else p.permute(0, 2, 3, 1)


def lovasz_softmax(probas, labels, classes="present", per_image=False, ignore=None):
    """Reference :146-161: probas [B,C,H,W], labels [B,H,W]."""
    p = _nhwc_probas(probas)
    return _lovasz.lovasz_softmax(p, to_array(labels, p.device), classes=_classes(classes),
                                  per_image=per_image, ignore=ignore)


def lovasz_softmax_flat(probas, labels, classes="present"):
    """Reference :164-192: flat probas [P,C], labels [P]."""
    p = to_array(probas)
    lb = to_array(labels, p.device)
    return _lovasz.lovasz_softmax(p.reshape(1, -1, 1, p.shape[-1]), lb.reshape(1, -1, 1),
                                  classes=_classes(classes))


def lovasz_hinge(logits, labels, per_image=True, ignore=None):
    """Reference :71-84: logits and binary labels [B,H,W]."""
    lg = to_array(logits)
    return _lovasz.lovasz_hinge(lg, to_array(labels, lg.device), per_image=per_image,
                                ignore=ignore)


def lovasz_hinge_flat(logits, labels):
    """Reference :87-104: flat logits and labels [P]."""
    lg = to_array(logits)
    return _lovasz.lovasz_hinge(lg.reshape(1, 1, -1), to_array(labels, lg.device).reshape(1, 1, -1),
                                per_image=False)


def flatten_binary_scores(scores, labels, ignore=None):
    """Reference :107-119, on the host (numpy): (scores [P], labels [P])
    without the ignored pixels."""
    s = to_numpy(scores).reshape(-1)
    lb = to_numpy(labels).reshape(-1)
    if ignore is None:
        return s, lb
    valid = lb != ignore
    return s[valid], lb[valid]


def flatten_probas(probas, labels, ignore=None):
    """Reference :195-211, on the host: (probas [P,C], labels [P])."""
    p = to_numpy(_nhwc_probas(probas))
    p = p.reshape(-1, p.shape[-1])
    lb = to_numpy(labels).reshape(-1)
    if ignore is None:
        return p, lb
    valid = lb != ignore
    return p[valid], lb[valid]


class StableBCELoss(torch.nn.Module):
    """Reference :122-128."""

    def forward(self, input, target):
        x = to_array(input)
        return _lovasz.stable_bce(x, to_array(target, x.device))


def binary_xloss(logits, labels, ignore=None):
    """Reference :131-140."""
    s, lb = flatten_binary_scores(logits, labels, ignore)
    return _lovasz.stable_bce(torch.from_numpy(s), torch.from_numpy(lb.astype(np.float32)))


def xloss(logits, labels, ignore=None):
    """Reference :213-217: cross-entropy with the label 255 ignored, NCHW
    logits [B,C,H,W] (or logits with the class last)."""
    lg = to_array(logits)
    lb = to_array(labels, lg.device)
    dim = 1 if lg.ndim == 4 else -1
    valid = (lb != 255).to(lg.dtype)
    nll = per_example_nll(lg, lb.clamp(0, lg.shape[dim] - 1), dim=dim)
    return (nll * valid).sum() / valid.sum().clamp(min=1.0)


def iou_binary(preds, labels, EMPTY=1.0, ignore=None, per_image=True):  # noqa: N803
    """Reference :26-43."""
    p, lb = to_numpy(preds), to_numpy(labels)
    if not per_image:
        p, lb = p[None], lb[None]
    ious = []
    for pi, li in zip(p, lb):
        intersection = ((li == 1) & (pi == 1)).sum()
        union = ((li == 1) | ((pi == 1) & (li != ignore))).sum()
        ious.append(EMPTY if not union else float(intersection) / float(union))
    return 100.0 * float(np.mean(ious))


def iou(preds, labels, C, EMPTY=1.0, ignore=None, per_image=False):  # noqa: N803
    """Reference :46-65."""
    p, lb = to_numpy(preds), to_numpy(labels)
    if not per_image:
        p, lb = p[None], lb[None]
    ious = []
    for pi, li in zip(p, lb):
        per_cls = []
        for i in range(C):
            if i != ignore:
                intersection = ((li == i) & (pi == i)).sum()
                union = ((li == i) | ((pi == i) & (li != ignore))).sum()
                per_cls.append(EMPTY if not union else float(intersection) / float(union))
        ious.append(per_cls)
    return 100.0 * np.array([np.mean(vals) for vals in zip(*ious)])


def isnan(x):
    return x != x


def mean(values, ignore_nan=False, empty=0):
    """Reference :225-243: the mean of an iterable (generators too), NaNs
    left out with ``ignore_nan``; ``empty`` for none ("raise" raises)."""
    vals = list(values)
    if ignore_nan:
        vals = [v for v in vals if not (isinstance(v, float) and math.isnan(v))]
    if not vals:
        if empty == "raise":
            raise ValueError("Empty mean")
        return empty
    return sum(vals) / len(vals)
