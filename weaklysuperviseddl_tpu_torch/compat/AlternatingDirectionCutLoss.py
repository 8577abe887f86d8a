"""Reference surface: TraditionalModel/AlternatingDirectionCutLoss.py, the
importable pieces of the script (port of
weaklysuperviseddl_tpu/compat/AlternatingDirectionCutLoss.py; the script's
training loop is ``pipelines/weakly.py`` + ``train/alternating.py``).

On the card ``apply_dense_crf`` filters with the bilateral kernel (K3) and
``refine_pseudo_mask`` refines with the refinement kernel (K1). The window
losses are the plain expressions (``losses/window.py``), as in the JAX
package.
"""

from __future__ import annotations

import numpy as np
import torch

from weaklysuperviseddl_tpu_torch.cam.cam import cam_bg, class_cams
from weaklysuperviseddl_tpu_torch.compat._adapt import (
    data_device,
    float_images,
    model_device,
    to_array,
    to_hw_batch,
)
from weaklysuperviseddl_tpu_torch.compat.ClassificationModel import FrozenResNetCAM  # noqa: F401
from weaklysuperviseddl_tpu_torch.compat.LayerCAM import LayerCAMGenerator  # noqa: F401
from weaklysuperviseddl_tpu_torch.compat.PsuedoMasks import keep_largest  # noqa: F401
from weaklysuperviseddl_tpu_torch.compat.SegmentationDataset import normalize_image
from weaklysuperviseddl_tpu_torch.compat.SegmentationModel import fit_prediction
from weaklysuperviseddl_tpu_torch.data.dataset import download_data  # noqa: F401
from weaklysuperviseddl_tpu_torch.losses.window import local_normalized_cut_loss, window_affinities
from weaklysuperviseddl_tpu_torch.masks import densecrf as _densecrf
from weaklysuperviseddl_tpu_torch.train.refine import refine_from_soft_predictions
from weaklysuperviseddl_tpu_torch.train.segmentation import train_segmentation_model
from weaklysuperviseddl_tpu_torch.utils.metrics import compute_iou_and_acc


def to_nhwc_any_channels(x, device=None):
    """As ``_adapt.to_nhwc`` for C-channel prediction maps (C may be 2): a
    map is NCHW when its channel dimension is at most 8 and its last is
    more than 8."""
    x = to_array(x, device)
    batched = x.ndim != 3
    if not batched:
        x = x[None]
    if x.shape[1] <= 8 and x.shape[-1] > 8:
        x = x.permute(0, 2, 3, 1)
    return x, batched


class LocalNormalizedCutLoss(torch.nn.Module):
    """Reference :65-105: (preds, images) → scalar. ``preds``: logits (the
    softmax is inside, as in the reference), NCHW or NHWC, batched or not;
    the images go to the predictions' device."""

    def __init__(self, sigma_color: float = 0.05, window_size: int = 5):
        super().__init__()
        self.sigma_color = sigma_color
        self.window_size = window_size

    def forward(self, preds, images):
        preds, _ = to_nhwc_any_channels(preds)
        return local_normalized_cut_loss(preds, float_images(images, preds.device),
                                         sigma_color=self.sigma_color,
                                         window_size=self.window_size)


def compute_affinities(image, sigma_color=0.1, sigma_space=5, window_size=5):
    """Reference :612-637: a list of [B,1,H,W] affinity maps, one per offset."""
    aff = window_affinities(float_images(image, None), sigma_color=sigma_color,
                            sigma_space=sigma_space, window_size=window_size)
    return [aff[:, k:k + 1] for k in range(aff.shape[1])]


def apply_dense_crf(img_np, cam_np, **kwargs) -> np.ndarray:
    """Reference :183-204: one HWC image (uint8, or floats in [0,1]) and its
    CAM [H,W] → the CRF's uint8 mask, numpy, computed on the inputs' device
    if either is a tensor, else on the card. ``kwargs`` go to
    ``masks/densecrf.densecrf_inference``."""
    dev = data_device(img_np, cam_np)
    img = to_array(img_np, dev).float()
    cam, _ = to_hw_batch(cam_np, dev)
    refined = _densecrf.apply_dense_crf(img[None], cam.float(), **kwargs)
    return refined[0].cpu().numpy().astype(np.uint8)


class CAMGenerator:
    """Reference :320-403, classic fc-weight CAM on the model's device."""

    def __init__(self, model: FrozenResNetCAM):
        self.model = model

    def generate_all_cams(self, image_tensor) -> torch.Tensor:
        """Every class's CAM of one image, [num_classes, h, w]."""
        cams, _ = class_cams(self.model, float_images(image_tensor, model_device(self.model)))
        return cams[0]

    def generate_bg_cam(self, image_tensor, valid_class_indices, alpha: float = 1.0):
        """(m_bg [224,224], the valid classes' largest CAM [224,224]) of one image."""
        dev = model_device(self.model)
        mask = torch.zeros((1, self.model.num_classes), device=dev)
        mask[0, to_array(valid_class_indices, dev).reshape(-1).long()] = 1.0
        m_bg, max_obj = cam_bg(self.model, float_images(image_tensor, dev), mask,
                               alpha=float(alpha))
        return m_bg[0], max_obj[0]


def train_model(model, optimizer_state_or_tx, criterion_ce=None, num_epochs: int = 3,
                train_loader=None, log=print):
    """Reference :684-707: epochs over (images, masks) batches. ``model``: a
    compat ``SegModelHandle``; ``optimizer_state_or_tx``: the optimizer
    ``initialize_model`` gave with it (another raises); ``criterion_ce`` is
    taken for the signature, the loss is the cross-entropy either way.
    ``train_loader``: (images uint8, {0,1} masks) arrays, or Batch objects
    whose foreground is trimap == 1. Returns the last epoch's loss."""
    if optimizer_state_or_tx is not model.state.optimizer:
        raise ValueError("train_model steps the optimizer initialize_model returned with "
                         "this model")
    if train_loader is None:
        raise ValueError("pass train_loader=(images, masks) arrays or a Batch iterable")
    if isinstance(train_loader, tuple):
        images, masks = train_loader
    else:
        ims, ms = [], []
        for batch in train_loader:
            ims.append(batch.image[:batch.num_valid])
            ms.append((batch.trimap[:batch.num_valid] == 1).astype(np.uint8))
        images, masks = np.concatenate(ims), np.concatenate(ms)
    model.state, final_loss = train_segmentation_model(
        model.state, images, masks, num_epochs=num_epochs, seg_size=model.input_size, log=log)
    return final_loss


def evaluate_model(model, test_loader, log=lambda s: None):
    """Reference :639-682, the script's variant: the truth is the shifted
    trimap inverted (fg = 1 − clip(t − 1 clipped at 0, 0, 1), ref :658-662),
    not trimap == 1. Returns (mean IoU, mean accuracy)."""
    ious, accs = [], []
    for batch in test_loader:
        preds = model(batch.image.astype(np.float32) / 255.0)["out"].argmax(dim=1)
        truth = torch.from_numpy(batch.trimap).to(preds.device).to(torch.int32)
        for i in range(batch.num_valid):
            true_fg = 1 - (truth[i] - 1).clamp(min=0).clamp(0, 1)
            iou, acc = compute_iou_and_acc(fit_prediction(preds[i], true_fg), true_fg)
            ious.append(float(iou))
            accs.append(float(acc))
    return sum(ious) / len(ious), sum(accs) / len(accs)


def infer_and_plot(model, img_path, pseudo_mask_path, save_path=None) -> np.ndarray:
    """Reference :835-861: predict one image file at 256² (ImageNet
    normalisation) and, with ``save_path``, save the image beside the
    prediction. Returns the predicted classes [256,256], numpy."""
    from PIL import Image

    img = Image.open(img_path).convert("RGB").resize((256, 256))
    pred = model(normalize_image(img)[None])["out"][0].argmax(dim=0).cpu().numpy()
    if save_path:
        from weaklysuperviseddl_tpu_torch.compat.Visualisation import visualize_mask

        visualize_mask(np.asarray(img), pred, title="Predicted Segmentation",
                       save_path=save_path)
    return pred


def refine_pseudo_mask(model, image, mask, lambda_boundary=0.1, threshold=0.5, lr=1e-2,
                       num_steps=20, sigma_color=0.1, window_size=5) -> torch.Tensor:
    """Reference :709-767, one image over the batched refinement on the
    model's device. ``model``: a compat ``SegModelHandle``; ``mask`` {0,1}
    or, as loaded from a PNG, {0,255} (a value above 1 is foreground where
    it is 255, the reference's ``== 255`` at :726). Returns the refined mask
    [H,W] float32."""
    dev = model_device(model.module)
    x = float_images(image, dev)
    m, _ = to_hw_batch(mask, dev)
    m = torch.where(m > 1, (m == 255).to(torch.int32), m.to(torch.int32))
    S = torch.softmax(model(x)["out"].permute(0, 2, 3, 1), dim=-1)
    refined, _ = refine_from_soft_predictions(
        S.contiguous(), x.contiguous(), m.contiguous(), lambda_boundary=lambda_boundary,
        threshold=threshold, lr=lr, num_steps=num_steps, sigma_color=sigma_color,
        window_size=window_size, loss="ncut")
    return refined[0].float()
