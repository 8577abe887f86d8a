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

Evaluation (``evaluate_segmentation_dataset``) is the reference's
``evaluate_model``: predict at ``seg_size``, nearest-resize the trimaps to
``eval_size`` and the predictions (legacy nearest) to the trimaps' size,
binarise the truth as trimap == 1, mean of per-image IoU and accuracy.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from weaklysuperviseddl_tpu_torch.data.preprocess import normalize_images as _normalize_images
from weaklysuperviseddl_tpu_torch.data.preprocess import preprocess_batch
from weaklysuperviseddl_tpu_torch.losses.basic import per_example_nll
from weaklysuperviseddl_tpu_torch.losses.lovasz import lovasz_softmax_per_image
from weaklysuperviseddl_tpu_torch.models.resnet import init_weights
from weaklysuperviseddl_tpu_torch.ops.resize import resize_nearest
from weaklysuperviseddl_tpu_torch.train.guard import GuardedAdam
from weaklysuperviseddl_tpu_torch.utils.metrics import compute_iou_and_acc


LOSSES = ("cross_entropy", "lovasz_softmax")


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
    ``np.random.default_rng(seed).permutation`` as in the JAX package. The
    printout follows SegmentationModel.py:116-120. Returns (state, the last
    epoch's summed loss)."""
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
            total = total + seg_train_step(state, x, m, valid, loss_fn)
        final_loss = float(total)
        log(f"[Run {run_id}] Epoch {epoch + 1}/{num_epochs}, Loss: {final_loss:.4f}")
        if eval_fn is not None:
            avg_iou, avg_acc = eval_fn(state)
            log(f"[Run {run_id}] Validation IoU: {avg_iou:.4f}, Accuracy: {avg_acc:.4f}")
    return state, final_loss


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
        x, _ = preprocess_batch(images_u8[idx], None, size=seg_size)
        preds = model(_normalize_images(x).permute(0, 3, 1, 2)).argmax(dim=1)
        t = trimaps[idx].to(torch.int32)
        if eval_size is not None and t.shape[1] != eval_size:
            t = resize_nearest(t, (eval_size, eval_size), torch_legacy=False, axes=(1, 2))
        true_fg = (t == 1).to(torch.int32)  # the reference's binarisation (:142)
        if preds.shape[1:] != true_fg.shape[1:]:
            preds = resize_nearest(preds, tuple(true_fg.shape[1:3]), torch_legacy=True,
                                   axes=(1, 2))
        iou_b, acc_b = compute_iou_and_acc(preds, true_fg)
        s_iou += iou_b.sum()
        s_acc += acc_b.sum()
    avg_iou, avg_acc = float(s_iou) / n, float(s_acc) / n
    if log:
        log(f"\n Model Evaluation on Test Set: IoU = {avg_iou:.4f} | Acc = {avg_acc:.4f}")
    return avg_iou, avg_acc
