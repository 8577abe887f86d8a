"""Reference surface: TraditionalModel/SegmentationModel.py (port of
weaklysuperviseddl_tpu/compat/SegmentationModel.py).

``train_segmentation_model(loss_fn, run_id, lr, num_epochs, batch_size, ...)``
keeps the reference's signature (SegmentationModel.py:59): it reads the
pseudo-mask PNG directories ``compat.PsuedoMasks`` wrote for ``run_id``,
trains a 2-class DeepLabV3 and returns ``(model, final_loss)``, the model a
``SegModelHandle`` that ``evaluate_model`` takes.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from weaklysuperviseddl_tpu_torch.compat._adapt import float_images, model_device
from weaklysuperviseddl_tpu_torch.device import resolve_device
from weaklysuperviseddl_tpu_torch.models.deeplabv3 import DeepLabV3
from weaklysuperviseddl_tpu_torch.ops.resize import resize_nearest
from weaklysuperviseddl_tpu_torch.train.segmentation import (
    SegTrainState,
    create_seg_state,
    evaluate_segmentation,
)
from weaklysuperviseddl_tpu_torch.train.segmentation import (
    train_segmentation_model as _train_seg,
)
from weaklysuperviseddl_tpu_torch.utils.metrics import compute_iou_and_acc


class SegModelHandle:
    """A DeepLabV3 with its training state, called as torchvision's deeplab
    is: ``model(x)["out"]`` gives NCHW logits for images in any layout (ref
    SegmentationModel.py:102), in eval mode and without gradient, on the
    model's device. ``.to(device)`` moves the model and its optimizer's
    moments and counters."""

    def __init__(self, module: DeepLabV3, state: SegTrainState, input_size: int = 256):
        self.module = module
        self.state = state
        self.input_size = input_size

    @torch.no_grad()
    def __call__(self, x) -> dict:
        x = float_images(x, model_device(self.module))
        was_training = self.module.training
        self.module.eval()
        try:
            return {"out": self.module(x.permute(0, 3, 1, 2))}
        finally:
            self.module.train(was_training)

    def eval(self):
        self.module.eval()
        return self

    def to(self, device=None):
        dev = resolve_device(device)
        self.module.to(dev)
        self.state.optimizer.to(dev)
        return self


def initialize_model(num_classes: int = 2, device=None, backbone_depth: int = 50,
                     width_multiplier: float = 1.0, input_size: int = 256,
                     lr: float = 1e-4, seed: int = 0):
    """DeepLabV3 with a ``num_classes`` head (ref SegmentationModel.py:86-88,
    SupervisedModel.py:13-16), seeded random weights on ``device`` (None:
    the card). Returns (handle, optimizer): the optimizer is the one
    ``train/segmentation.py`` steps (Adam behind the non-finite guard)."""
    module = DeepLabV3(num_classes=num_classes, backbone_depth=backbone_depth,
                       width_multiplier=width_multiplier)
    state = create_seg_state(module, seed, lr=lr, device=resolve_device(device))
    return SegModelHandle(module, state, input_size), state.optimizer


def read_pseudo_masks(root: str, run_id: str):
    """The PNG pairs ``compat.PsuedoMasks.generate_pseudo_masks`` wrote for
    ``run_id`` under ``root``: (images [N,H,W,3] uint8, masks [N,H,W] {0,1}),
    in sorted file-name order."""
    from PIL import Image

    image_dir = os.path.join(root, f"images_{run_id}")
    mask_dir = os.path.join(root, f"pseudo_masks_{run_id}")
    images, masks = [], []
    for fname in sorted(os.listdir(mask_dir)):
        m = np.asarray(Image.open(os.path.join(mask_dir, fname)).convert("L"))
        masks.append((m == 255).astype(np.uint8))
        images.append(np.asarray(Image.open(os.path.join(image_dir, fname)).convert("RGB")))
    return np.stack(images), np.stack(masks)


def train_segmentation_model(loss_fn="cross_entropy", run_id="default", lr=1e-4,
                             num_epochs=10, batch_size=4, val_split=0.2,
                             root: str | None = None, val_loader=None,
                             backbone_depth: int = 50, width_multiplier: float = 1.0,
                             seg_size: int = 256, log=print, device=None):
    """Reference signature (SegmentationModel.py:59-122), on ``device``
    (None: the card). ``val_loader``: a zero-argument factory of Batch
    iterators, evaluated after every epoch."""
    images, masks = read_pseudo_masks(root or tempfile.gettempdir(), run_id)
    handle, _ = initialize_model(2, device=device, backbone_depth=backbone_depth,
                                 width_multiplier=width_multiplier, input_size=seg_size, lr=lr)
    eval_fn = None
    if val_loader is not None:
        eval_fn = lambda st: evaluate_segmentation(  # noqa: E731
            st.model, val_loader(), seg_size=seg_size, eval_size=None)
    handle.state, final_loss = _train_seg(
        handle.state, images, masks, loss_fn=loss_fn, num_epochs=num_epochs,
        batch_size=batch_size, seg_size=seg_size, run_id=run_id, eval_fn=eval_fn, log=log)
    return handle, final_loss


def fit_prediction(pred: torch.Tensor, truth: torch.Tensor) -> torch.Tensor:
    """A [H,W] prediction nearest-resized (torch's legacy rule) to the truth's shape."""
    if pred.shape != truth.shape:
        pred = resize_nearest(pred, tuple(truth.shape), torch_legacy=True)
    return pred


def evaluate_model(model: SegModelHandle, test_loader, log=print):
    """Reference signature (SegmentationModel.py:126-159): mean per-image
    binary IoU and accuracy against trimap == 1 over Batch objects, the
    images in [0,1] at their own size."""
    ious, accs = [], []
    for batch in test_loader:
        preds = model(batch.image.astype(np.float32) / 255.0)["out"].argmax(dim=1)
        truth = torch.from_numpy(batch.trimap).to(preds.device)
        for i in range(batch.num_valid):
            true_mask = (truth[i] == 1).to(torch.int32)
            iou, acc = compute_iou_and_acc(fit_prediction(preds[i], true_mask), true_mask)
            ious.append(float(iou))
            accs.append(float(acc))
    avg_iou = sum(ious) / len(ious)
    avg_acc = sum(accs) / len(accs)
    log(f"\n Model Evaluation on Test Set: IoU = {avg_iou:.4f} | Acc = {avg_acc:.4f}")
    return avg_iou, avg_acc
