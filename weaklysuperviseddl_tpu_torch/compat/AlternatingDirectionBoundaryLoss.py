"""Reference surface: TraditionalModel/AlternatingDirectionBoundaryLoss.py
(port of weaklysuperviseddl_tpu/compat/AlternatingDirectionBoundaryLoss.py)."""

from __future__ import annotations

import os

import torch

from weaklysuperviseddl_tpu_torch.compat._adapt import float_images, model_device
from weaklysuperviseddl_tpu_torch.compat.AlternatingDirectionCutLoss import (  # noqa: F401
    refine_pseudo_mask,
    to_nhwc_any_channels,
)
from weaklysuperviseddl_tpu_torch.compat.SegmentationModel import SegModelHandle
from weaklysuperviseddl_tpu_torch.compat.SegmentationModel import (
    initialize_model as _initialize_model,
)
from weaklysuperviseddl_tpu_torch.config import (
    AlternatingConfig,
    DataConfig,
    ExperimentConfig,
    RefineConfig,
    SegConfig,
)
from weaklysuperviseddl_tpu_torch.data.mask_store import MaskStore
from weaklysuperviseddl_tpu_torch.losses.window import boundary_loss
from weaklysuperviseddl_tpu_torch.masks.pseudo import cam_to_mask
from weaklysuperviseddl_tpu_torch.train.alternating import run_alternating_training as _run
from weaklysuperviseddl_tpu_torch.train.segmentation import evaluate_segmentation


class ConstrainToBoundaryLossSingle(torch.nn.Module):
    """Reference :12-70: (preds [C,H,W] softmax output, image [3,H,W]) →
    scalar, batched inputs too. The reference's ``compute_affinities_single``
    (a defective @staticmethod) is part of the loss."""

    def __init__(self, sigma_color=0.1, sigma_space=5, window_size=5, eps=1e-8):
        super().__init__()
        self.sigma_color = sigma_color
        self.sigma_space = sigma_space
        self.window_size = window_size
        self.eps = eps

    def forward(self, preds, image):
        preds, _ = to_nhwc_any_channels(preds)
        return boundary_loss(preds, float_images(image, preds.device),
                             sigma_color=self.sigma_color, sigma_space=self.sigma_space,
                             window_size=self.window_size)


def setup_dirs(mask_dir="./pseudo_masks", image_dir="./images"):
    """Reference :74-77, the default paths relative rather than /content."""
    os.makedirs(mask_dir, exist_ok=True)
    os.makedirs(image_dir, exist_ok=True)
    return mask_dir, image_dir


def initialize_model(num_classes: int = 2, **kwargs) -> SegModelHandle:
    """Reference :106-110: the handle of ``SegmentationModel.initialize_model``."""
    handle, _ = _initialize_model(num_classes=num_classes, **kwargs)
    return handle


def run_alternating_training(loader, layercam_gen, joint_transform=True,
                             num_alternations: int = 5, epochs_per_round: int = 15,
                             lambda_boundary: float = 0.5, momentum: float = 0.9,
                             sigma_color: float = 0.1, sigma_space: float = 10,
                             cam_thresh: float = 0.5, alpha: float = 1.0,
                             keep_largest_masks: bool = True, visualize_idx: int = 0,
                             eval_loader=None, seg_kwargs: dict | None = None, log=print):
    """Reference :153-206: the initial pseudo-masks from ``layercam_gen`` (raw
    loader images, as in the JAX package), then train ↔ refine with the
    boundary loss (75 steps, threshold 0.5, one sweep a round, ref :146), on
    the CAM model's device. ``seg_kwargs``: seg_size, backbone_depth,
    width_multiplier, lr, batch_size; ``eval_loader``: a zero-argument
    factory of Batch iterators. ``joint_transform``, ``momentum`` and
    ``visualize_idx`` are taken for the signature.

    Returns (model handle, MaskStore) rather than filling global PNG
    directories."""
    seg_kwargs = seg_kwargs or {}
    seg_size = seg_kwargs.get("seg_size", 256)
    depth = seg_kwargs.get("backbone_depth", 50)
    width = seg_kwargs.get("width_multiplier", 1.0)

    store = MaskStore()
    img_id = 0
    for batch in loader:
        cams = layercam_gen.generate(batch.image, class_idx=batch.label, alpha=alpha)
        masks = cam_to_mask(cams, cam_thresh, keep_largest_masks).cpu().numpy()
        for i in range(batch.num_valid):
            store.put(f"{img_id:05d}", batch.image[i], masks[i])
            img_id += 1

    handle, _ = _initialize_model(2, device=model_device(layercam_gen.model),
                                  backbone_depth=depth, width_multiplier=width,
                                  input_size=seg_size, lr=seg_kwargs.get("lr", 1e-4))
    cfg = ExperimentConfig(
        data=DataConfig(seg_size=seg_size),
        seg=SegConfig(batch_size=seg_kwargs.get("batch_size", 4), backbone_depth=depth,
                      width_multiplier=width),
        alternating=AlternatingConfig(
            num_alternations=num_alternations, epochs_per_round=epochs_per_round,
            refine_repeats=1,
            refine=RefineConfig(lambda_boundary=lambda_boundary, threshold=0.5, num_steps=75,
                                sigma_color=sigma_color, sigma_space=sigma_space,
                                loss="boundary")))
    eval_fn = None
    if eval_loader is not None:
        eval_fn = lambda st: evaluate_segmentation(  # noqa: E731
            st.model, eval_loader(), seg_size=seg_size, eval_size=None)
    handle.state, store = _run(handle.state, store, cfg, eval_fn=eval_fn, log=log)
    log("Alternating training and pseudo mask updates completed.")
    return handle, store
