"""DeepLabV3 segmentation training (port of weaklysuperviseddl_tpu/train/segmentation.py;
ref TraditionalModel/SegmentationModel.py:59-159).

Adam (lr 1e-4) over all parameters behind the non-finite-gradient guard, CE
(or, with ``loss_fn="lovasz_softmax"``, the per-image Lovász-Softmax over the
present classes of the softmax) on pseudo-masks clamped to {0,1}, BatchNorm in training mode (batch
statistics, flax's running-statistics update: ``models/resnet.BatchNorm2d``).
Batches are fixed-shape: the ragged tail repeats its last index and those
rows carry weight 0 in the loss, as in the JAX package (they still enter the
batch statistics, as they do there). The dataset is uploaded once and each
batch is a gather on the device: uint8 → preprocess → ImageNet
normalisation, masks nearest-resized (half-pixel centres) to ``seg_size``.
A bfloat16 DeepLabV3 (``seg.dtype``) trains the same way: its parameters, its
gradients and Adam's state are float32, its forward and backward run in
bfloat16, and its logits come back float32, so the losses, the predictions
and the evaluators are float32.

The ASPP's dropout is seeded before every step from (seed + 1, epoch, step)
through ``dropout_seed``, a fixed integer mix, so ``seed`` alone fixes a run
in any process, as the JAX package's keys (``PRNGKey(seed + 1)``, split per
epoch, folded with the step) do; the bits differ from JAX's threefry.

Evaluation (``evaluate_segmentation_dataset``, and ``evaluate_segmentation``
over a loader) is the reference's ``evaluate_model``: predict at
``seg_size``, nearest-resize the trimaps to ``eval_size`` and the predictions
(legacy nearest) to the trimaps' size, binarise the truth ("fg1": trimap ==
1; "shifted_inverted": 1 − clip(t − 1, 0, 1), CutLoss.py:658-662), mean of
per-image IoU and accuracy. The supervised baseline's
(``evaluate_multiclass_dataset``, and ``evaluate_multiclass`` over a loader,
ref SupervisedModel.py:44-83): per batch the nanmean of per-class IoU and the
pixel accuracy against trimap == 1, averaged over batches, padded rows out of
every counter.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from weaklysuperviseddl_tpu_torch.data.preprocess import normalize_images as _normalize_images
from weaklysuperviseddl_tpu_torch.data.preprocess import preprocess_batch
from weaklysuperviseddl_tpu_torch.losses.basic import per_example_nll
from weaklysuperviseddl_tpu_torch.losses.lovasz import lovasz_softmax_per_image
from weaklysuperviseddl_tpu_torch.models.deeplabv3 import seed_dropout
from weaklysuperviseddl_tpu_torch.models.resnet import init_weights
from weaklysuperviseddl_tpu_torch.ops.resize import resize_nearest
from weaklysuperviseddl_tpu_torch.train.guard import GuardedAdam
from weaklysuperviseddl_tpu_torch.utils.metrics import compute_iou_and_acc, per_class_iou


LOSSES = ("cross_entropy", "lovasz_softmax")
BINARIZE = ("fg1", "shifted_inverted")
_M64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def dropout_seed(seed: int, epoch: int, step: int) -> int:
    """The dropout generator's seed for one training step: splitmix64 rounds
    over (seed, epoch, step), a pure function of the three in any process."""
    h = 0
    for v in (seed, epoch, step):
        h = _splitmix64(h ^ (v & _M64))
    return h


@dataclass
class SegTrainState:
    """The model (parameters and BatchNorm statistics) and its optimizer."""

    model: torch.nn.Module
    optimizer: GuardedAdam
    step: int = 0


def create_seg_state(model: torch.nn.Module, seed: int, lr: float = 1e-4,
                     device=None) -> SegTrainState:
    """Seeded random weights (``init_weights``) on ``device`` and Adam behind
    the non-finite-gradient guard."""
    init_weights(model, torch.Generator().manual_seed(seed))
    if device is not None:
        model.to(device)
    return SegTrainState(model=model, optimizer=GuardedAdam(model.parameters(), lr=lr))


def seg_train_step(state: SegTrainState, images: torch.Tensor, masks: torch.Tensor,
                   valid: torch.Tensor, loss_fn: str = "cross_entropy") -> torch.Tensor:
    """One step on normalised [B,H,W,3] images and [B,H,W] integer masks;
    ``valid`` [B] masks padded rows out of the loss. Returns the loss (0-dim,
    on the device)."""
    if loss_fn not in LOSSES:
        raise ValueError(f"unknown loss_fn {loss_fn!r}; expected one of {LOSSES}")
    model = state.model
    model.train()
    logits = model(images.permute(0, 3, 1, 2))                      # [B,C,H,W]
    masks_c = masks.clamp(0, 1)                                     # ref :100 clamp(max=1)
    if loss_fn == "lovasz_softmax":
        # per image, so that padded rows can be weighted out
        probas = torch.softmax(logits, dim=1).permute(0, 2, 3, 1)
        per = lovasz_softmax_per_image(probas, masks_c, classes="present")
    else:
        per = per_example_nll(logits, masks_c, dim=1).mean(dim=(1, 2))  # [B]
    w = valid.float()
    loss = (per * w).sum() / w.sum().clamp(min=1.0)
    state.optimizer.zero_grad()
    loss.backward()
    state.optimizer.step()
    state.step += 1
    return loss.detach()


def _as_device_tensor(a, device) -> torch.Tensor:
    return a.to(device) if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a)).to(device)


def _prep(raw: torch.Tensor, m: torch.Tensor, seg_size: int):
    x, _ = preprocess_batch(raw, None, size=seg_size)
    x = _normalize_images(x)
    m = m.to(torch.int32)
    if m.shape[1] != seg_size or m.shape[2] != seg_size:
        m = resize_nearest(m, (seg_size, seg_size), torch_legacy=False, axes=(1, 2))
    return x, m


def train_segmentation_model(state: SegTrainState, images, masks,
                             loss_fn: str = "cross_entropy", num_epochs: int = 10,
                             batch_size: int = 4, seg_size: int = 256, seed: int = 0,
                             run_id: str = "default", eval_fn=None, log=print):
    """Epoch loop over an in-memory pseudo-mask dataset (images [N,H,W,3]
    uint8, masks [N,H,W] {0,1}; numpy or tensors). The per-epoch order is
    ``np.random.default_rng(seed).permutation`` as in the JAX package, and the
    dropout is seeded before step t of epoch e with ``dropout_seed(seed + 1,
    e, t)``. The printout follows SegmentationModel.py:116-120. Returns
    (state, the last epoch's summed loss)."""
    dev = next(state.model.parameters()).device
    images = _as_device_tensor(images, dev)
    masks = _as_device_tensor(masks, dev)
    n = images.shape[0]
    rng = np.random.default_rng(seed)
    final_loss = 0.0
    T = (n + batch_size - 1) // batch_size
    for epoch in range(num_epochs):
        order = rng.permutation(n)
        total = torch.zeros((), device=dev)
        for t in range(T):
            idx = order[t * batch_size:(t + 1) * batch_size]
            nv = len(idx)
            if nv < batch_size:
                idx = np.concatenate([idx, np.repeat(idx[-1], batch_size - nv)])
            idx_t = torch.from_numpy(idx).to(dev)
            x, m = _prep(images[idx_t], masks[idx_t], seg_size)
            valid = torch.arange(batch_size, device=dev) < nv
            seed_dropout(state.model, dropout_seed(seed + 1, epoch, t))
            total = total + seg_train_step(state, x, m, valid, loss_fn)
        final_loss = float(total)
        log(f"[Run {run_id}] Epoch {epoch + 1}/{num_epochs}, Loss: {final_loss:.4f}")
        if eval_fn is not None:
            avg_iou, avg_acc = eval_fn(state)
            log(f"[Run {run_id}] Validation IoU: {avg_iou:.4f}, Accuracy: {avg_acc:.4f}")
    return state, final_loss


def _padded_index_table(n: int, batch_size: int):
    """[T,B] indices over n rows (the ragged tail repeats the last one) and
    the [T,B] mask of real rows."""
    T = (n + batch_size - 1) // batch_size
    idx = np.concatenate([np.arange(n), np.repeat(n - 1, T * batch_size - n)])
    valid = np.arange(T * batch_size) < n
    return idx.reshape(T, batch_size), valid.reshape(T, batch_size)


def _predict(model: torch.nn.Module, raw: torch.Tensor, seg_size: int, normalize: bool):
    """[B,H,W,3] uint8 → [B,seg_size,seg_size] argmax classes."""
    x, _ = preprocess_batch(raw, None, size=seg_size)
    if normalize:
        x = _normalize_images(x)
    return model(x.permute(0, 3, 1, 2)).argmax(dim=1)


def _binary_truth(trimaps: torch.Tensor, eval_size: int | None, binarize: str) -> torch.Tensor:
    t = trimaps.to(torch.int32)
    if eval_size is not None and t.shape[1] != eval_size:
        t = resize_nearest(t, (eval_size, eval_size), torch_legacy=False, axes=(1, 2))
    if binarize == "fg1":
        return (t == 1).to(torch.int32)  # the reference's binarisation (:142)
    if binarize == "shifted_inverted":
        return 1 - (t - 1).clamp(min=0).clamp(0, 1)
    raise ValueError(f"unknown binarize {binarize!r}; expected one of {BINARIZE}")


def _fit_preds(preds: torch.Tensor, truth: torch.Tensor) -> torch.Tensor:
    if preds.shape[1:] != truth.shape[1:]:
        preds = resize_nearest(preds, tuple(truth.shape[1:3]), torch_legacy=True, axes=(1, 2))
    return preds


def _per_image_metrics(model, raw, trimaps, seg_size, eval_size, normalize, binarize):
    """Per-image (IoU, accuracy) of one batch, each [B]."""
    truth = _binary_truth(trimaps, eval_size, binarize)
    return compute_iou_and_acc(_fit_preds(_predict(model, raw, seg_size, normalize), truth),
                               truth)


def _multiclass_metrics(model, raw, trimaps, num_classes, seg_size, normalize, valid=None):
    """One batch's (nanmean per-class IoU, pixel accuracy), 0-dim tensors."""
    masks = (trimaps.to(torch.int32) == 1).to(torch.int32)
    preds = _fit_preds(_predict(model, raw, seg_size, normalize), masks)
    _, mean_iou, pixel_acc = per_class_iou(preds, masks, num_classes, valid=valid)
    return mean_iou, pixel_acc


@torch.no_grad()
def evaluate_segmentation_dataset(model: torch.nn.Module, images_u8, trimaps,
                                  batch_size: int = 8, seg_size: int = 256,
                                  eval_size: int | None = 224, log=None):
    """Mean per-image (IoU, accuracy) over the test set (images [N,H,W,3]
    uint8, trimaps [N,h,w] uint8, numpy or tensors)."""
    dev = next(model.parameters()).device
    model.eval()
    images_u8 = _as_device_tensor(images_u8, dev)
    trimaps = _as_device_tensor(trimaps, dev)
    n = images_u8.shape[0]
    s_iou = torch.zeros((), device=dev)
    s_acc = torch.zeros((), device=dev)
    for idx in torch.from_numpy(np.arange(n)).to(dev).split(batch_size):
        iou_b, acc_b = _per_image_metrics(model, images_u8[idx], trimaps[idx], seg_size,
                                          eval_size, True, "fg1")
        s_iou += iou_b.sum()
        s_acc += acc_b.sum()
    avg_iou, avg_acc = float(s_iou) / n, float(s_acc) / n
    if log:
        log(f"\n Model Evaluation on Test Set: IoU = {avg_iou:.4f} | Acc = {avg_acc:.4f}")
    return avg_iou, avg_acc


@torch.no_grad()
def evaluate_segmentation(model: torch.nn.Module, loader, seg_size: int = 256,
                          eval_size: int | None = 224, binarize: str = "fg1",
                          normalize: bool = True, log=None):
    """``evaluate_segmentation_dataset``'s metrics over a loader of padded
    batches (``image``, ``trimap``, ``num_valid``), with the truth binarised
    by ``binarize``."""
    dev = next(model.parameters()).device
    model.eval()
    ious, accs = [], []
    for batch in loader:
        iou_b, acc_b = _per_image_metrics(
            model, _as_device_tensor(batch.image, dev), _as_device_tensor(batch.trimap, dev),
            seg_size, eval_size, normalize, binarize)
        ious.extend(iou_b[: batch.num_valid].tolist())
        accs.extend(acc_b[: batch.num_valid].tolist())
    avg_iou, avg_acc = sum(ious) / len(ious), sum(accs) / len(accs)
    if log:
        log(f"\n Model Evaluation on Test Set: IoU = {avg_iou:.4f} | Acc = {avg_acc:.4f}")
    return avg_iou, avg_acc


@torch.no_grad()
def evaluate_multiclass_dataset(model: torch.nn.Module, images_u8, trimaps,
                                num_classes: int = 2, batch_size: int = 8,
                                seg_size: int = 256, normalize: bool = True, log=None):
    """The supervised baseline's metrics over the test set (images [N,H,W,3]
    uint8, trimaps [N,h,w] uint8, numpy or tensors) in fixed-shape batches,
    the padded rows of the last one out of every counter. Returns (acc, iou)."""
    dev = next(model.parameters()).device
    model.eval()
    images_u8 = _as_device_tensor(images_u8, dev)
    trimaps = _as_device_tensor(trimaps, dev)
    idx_table, valid_table = _padded_index_table(images_u8.shape[0], batch_size)
    s_iou = torch.zeros((), device=dev)
    s_acc = torch.zeros((), device=dev)
    for idx, valid in zip(torch.from_numpy(idx_table).to(dev),
                          torch.from_numpy(valid_table).to(dev)):
        mean_iou, pixel_acc = _multiclass_metrics(model, images_u8[idx], trimaps[idx],
                                                  num_classes, seg_size, normalize, valid)
        s_iou += mean_iou
        s_acc += pixel_acc
    T = idx_table.shape[0]
    avg_acc, avg_iou = float(s_acc) / T, float(s_iou) / T
    if log:
        log(f"Val Acc: {avg_acc:.4f} | Val IoU: {avg_iou:.4f}")
    return avg_acc, avg_iou


@torch.no_grad()
def evaluate_multiclass(model: torch.nn.Module, loader, num_classes: int = 2,
                        seg_size: int = 256, normalize: bool = True, log=None):
    """``evaluate_multiclass_dataset``'s metrics over a loader of padded
    batches (``image``, ``trimap``, ``num_valid``). Returns (acc, iou)."""
    dev = next(model.parameters()).device
    model.eval()
    total_acc = total_iou = 0.0
    batches_n = 0
    for batch in loader:
        k = batch.num_valid
        mean_iou, pixel_acc = _multiclass_metrics(
            model, _as_device_tensor(batch.image[:k], dev),
            _as_device_tensor(batch.trimap[:k], dev), num_classes, seg_size, normalize)
        total_iou += float(mean_iou)
        total_acc += float(pixel_acc)
        batches_n += 1
    avg_acc, avg_iou = total_acc / batches_n, total_iou / batches_n
    if log:
        log(f"Val Acc: {avg_acc:.4f} | Val IoU: {avg_iou:.4f}")
    return avg_acc, avg_iou
