"""Fully supervised DeepLabV3 baseline, the upper bound (port of
weaklysuperviseddl_tpu/pipelines/supervised.py).

Reference: FullySupervisedModel/SupervisedModel.py:85-123: DeepLabV3 (random
init, 2 classes) on the true binarised masks, Adam(1e-4), CE; a validation
per epoch; ``test_runs`` evaluations of the test set, then mean ± stdev of
pixel accuracy and IoU. The reference's test runs repeat the same
deterministic evaluation; they are kept for the printout. DeepLabV3 computes
in float32 whatever ``seg.dtype`` says, as the JAX package's baseline does.
"""

from __future__ import annotations

import numpy as np
import torch

from weaklysuperviseddl_tpu_torch.config import ExperimentConfig
from weaklysuperviseddl_tpu_torch.data.dataset import load_split_data
from weaklysuperviseddl_tpu_torch.data.loader import stack_dataset
from weaklysuperviseddl_tpu_torch.device import resolve_device
from weaklysuperviseddl_tpu_torch.pipelines.weakly import (
    build_seg_model,
    check_supported,
    load_test_arrays,
)
from weaklysuperviseddl_tpu_torch.train.segmentation import (
    create_seg_state,
    evaluate_multiclass_dataset,
    train_segmentation_model,
)
from weaklysuperviseddl_tpu_torch.utils.metrics import mean_std


def _true_masks(ds):
    """Images and the binarised trimaps: foreground where trimap == 1."""
    images = np.stack(ds.images)
    masks = np.stack([(t == 1).astype(np.uint8) for t in ds.trimaps])
    return images, masks


def run_supervised_training(cfg: ExperimentConfig | None = None, num_epochs: int | None = None,
                            train_ratio: float = 0.85, test_runs: int = 3, log=print,
                            device=None):
    """Train and evaluate the baseline. Returns ``(state, {"acc_mean",
    "acc_std", "iou_mean", "iou_std"})``."""
    cfg = cfg or ExperimentConfig()
    check_supported(cfg)
    dev = resolve_device(device)
    d = cfg.data
    epochs = num_epochs if num_epochs is not None else cfg.seg.epochs

    train_ds, val_ds = load_split_data(
        d.root, train_ratio=train_ratio, seed=d.seed, synthetic_size=d.synthetic_size,
        image_size=d.image_size, num_classes=d.num_classes)
    test_arrays = load_test_arrays(cfg, dev)
    log(f"Train batches: {len(train_ds) // d.batch_size} | "
        f"Val batches: {len(val_ds) // d.eval_batch_size} | "
        f"Test batches: {int(test_arrays[0].shape[0]) // d.eval_batch_size}")

    state = create_seg_state(build_seg_model(cfg), seed=cfg.seed, lr=cfg.seg.lr, device=dev)
    images, masks = _true_masks(train_ds)
    val_images, _, val_trimaps = stack_dataset(val_ds)
    val_arrays = (torch.from_numpy(val_images).to(dev), torch.from_numpy(val_trimaps).to(dev))

    def val_eval(st):
        acc, iou = evaluate_multiclass_dataset(
            st.model, *val_arrays, num_classes=cfg.seg.num_classes,
            batch_size=d.eval_batch_size, seg_size=d.seg_size)
        return iou, acc

    state, _ = train_segmentation_model(
        state, images, masks, loss_fn=cfg.seg.loss_fn, num_epochs=epochs,
        batch_size=cfg.seg.batch_size, seg_size=d.seg_size, seed=cfg.seed,
        run_id="supervised", eval_fn=val_eval, log=log)

    accs, ious = [], []
    for run in range(test_runs):
        log(f"\nTest Run {run + 1}/{test_runs}")
        acc, iou = evaluate_multiclass_dataset(
            state.model, *test_arrays, num_classes=cfg.seg.num_classes,
            batch_size=d.eval_batch_size, seg_size=d.seg_size)
        accs.append(acc)
        ious.append(iou)
        log(f"Pixel Acc: {acc:.4f} | IoU: {iou:.4f}")

    acc_m, acc_s = mean_std(accs)
    iou_m, iou_s = mean_std(ious)
    log("\nFinal Test Results:")
    log(f"Avg Pixel Acc: {acc_m:.4f} ± {acc_s:.4f}")
    log(f"Avg IoU: {iou_m:.4f} ± {iou_s:.4f}")
    return state, {"acc_mean": acc_m, "acc_std": acc_s, "iou_mean": iou_m, "iou_std": iou_s}
