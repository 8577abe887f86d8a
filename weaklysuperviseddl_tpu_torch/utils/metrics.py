"""Evaluation metrics (port of weaklysuperviseddl_tpu/utils/metrics.py).

The counters are sums, so batches (and, later, devices) combine by adding
them before the finishing step.
  * binary IoU / pixel accuracy — ref TraditionalModel/ExtraUtilities.py:4-21
  * macro-F1 per-class counters — ref TraditionalModel/ClassificationModel.py:109-150
  * per-class IoU and pixel accuracy — ref FullySupervisedModel/SupervisedModel.py:53-79
  * mean and sample stdev over repeats — ref TraditionalModel/Abalations.py:62-81
"""

from __future__ import annotations

import math

import torch


def compute_iou_and_acc(pred_mask: torch.Tensor, true_mask: torch.Tensor):
    """Binary IoU + pixel accuracy of [..., H, W] mask pairs, one value per
    leading index (a scalar for one [H,W] pair); foreground is ``> 0``.
    iou = |pred∧true| / (|pred∨true| + 1e-8); acc counts exact value equality."""
    pred_fg = pred_mask > 0
    true_fg = true_mask > 0
    intersection = (pred_fg & true_fg).sum(dim=(-2, -1)).float()
    union = (pred_fg | true_fg).sum(dim=(-2, -1)).float()
    correct = (pred_mask == true_mask).sum(dim=(-2, -1)).float()
    iou = intersection / (union + 1e-8)
    acc = correct / (true_mask.shape[-2] * true_mask.shape[-1])
    return iou, acc


def binary_confusion_counts(pred_mask: torch.Tensor, true_mask: torch.Tensor) -> dict:
    """Raw counters of binary IoU and accuracy (foreground ``> 0``), which
    add across batches and ranks; ``finish_iou_and_acc`` turns them into the
    metrics."""
    pred_fg = pred_mask > 0
    true_fg = true_mask > 0
    return {
        "intersection": (pred_fg & true_fg).sum(),
        "union": (pred_fg | true_fg).sum(),
        "correct": (pred_mask == true_mask).sum(),
        "total": torch.tensor(true_mask.numel(), device=true_mask.device),
    }


def finish_iou_and_acc(counts: dict):
    """(IoU, accuracy) of summed ``binary_confusion_counts``."""
    iou = counts["intersection"] / (counts["union"] + 1e-8)
    acc = counts["correct"] / counts["total"]
    return iou, acc


def classification_counts(preds: torch.Tensor, labels: torch.Tensor, num_classes: int,
                          valid: torch.Tensor | None = None):
    """Per-class TP/FP/FN counters + correct/total (ref ClassificationModel.py:116-139).
    ``valid`` ([B] bool) excludes padded rows from every counter."""
    v = torch.ones(labels.shape[0], dtype=torch.bool, device=labels.device) if valid is None \
        else valid.bool()
    classes = torch.arange(num_classes, device=labels.device)[None, :]
    one_hot_pred = (classes == preds[:, None]) & v[:, None]
    one_hot_true = (classes == labels[:, None]) & v[:, None]
    return {
        "tp": (one_hot_pred & one_hot_true).sum(0),
        "fp": (one_hot_pred & ~one_hot_true).sum(0),
        "fn": (~one_hot_pred & one_hot_true).sum(0),
        "correct": ((preds == labels) & v).sum(),
        "total": v.sum(),
    }


def finish_macro_f1(counts):
    """(accuracy in %, macro-F1) from accumulated counters (ref ClassificationModel.py:142-147)."""
    tp, fp, fn = (counts[k].float() for k in ("tp", "fp", "fn"))
    precision = tp / (tp + fp + 1e-8)
    recall = tp / (tp + fn + 1e-8)
    f1 = 2 * precision * recall / (precision + recall + 1e-8)
    acc = 100.0 * counts["correct"].float() / counts["total"].float()
    return acc, f1.mean()


def per_class_iou(preds: torch.Tensor, masks: torch.Tensor, num_classes: int,
                  valid: torch.Tensor | None = None):
    """Per-class IoU of [B,H,W] predictions against masks, NaN where a class
    is in neither, and pixel accuracy. Returns (ious [num_classes], their
    nanmean, pixel_acc), 0-dim tensors on the inputs' device. ``valid`` ([B]
    bool) takes padded rows out of every counter, which equals slicing them
    off first."""
    v = None if valid is None else valid.bool()[:, None, None]
    ious = []
    for cls in range(num_classes):
        pred_inds = preds == cls
        target_inds = masks == cls
        if v is not None:
            pred_inds = pred_inds & v
            target_inds = target_inds & v
        intersection = (pred_inds & target_inds).sum()
        union = (pred_inds | target_inds).sum()
        ious.append(torch.where(union == 0, torch.nan, intersection / union.clamp(min=1)))
    ious = torch.stack(ious)
    eq = preds == masks
    if v is None:
        pixel_acc = eq.float().mean()
    else:
        per_image = masks.shape[-1] * masks.shape[-2]
        pixel_acc = (eq & v).float().sum() / (valid.float().sum() * per_image).clamp(min=1.0)
    return ious, torch.nanmean(ious), pixel_acc


def mean_std(values):
    """Mean and sample standard deviation (0 for one value), as the
    reference's ``statistics.mean``/``stdev``."""
    values = list(values)
    n = len(values)
    m = sum(values) / n
    s = math.sqrt(sum((v - m) ** 2 for v in values) / (n - 1)) if n > 1 else 0.0
    return m, s
