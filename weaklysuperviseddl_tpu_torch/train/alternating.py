"""Alternating train ↔ refine loop (port of weaklysuperviseddl_tpu/train/alternating.py;
ref AlternatingDirectionCutLoss.py:791-818).

Per alternation: train the segmentation model on the current masks, evaluate,
then ``refine_repeats`` refinement sweeps over every mask, and write the masks
back to the store once. The store's images are uploaded once for the whole
run and the masks stay on the device across training and sweeps. A sweep
walks the store in order in batches (gather → preprocess → normalise →
DeepLabV3 without gradient → softmax → refinement → masks written back in
place); duplicate indices of the padded tail write identical values. The
softmax takes DeepLabV3's float32 logits whatever its compute dtype, so the
refinement's S is float32, as in the JAX package.
With a ``checkpoint_dir``, each alternation ends with a snapshot of the train
state and the store (``utils/checkpoint.save_alternation``);
``start_iteration`` continues a run from one (``restore_alternation``).
"""

from __future__ import annotations

import numpy as np
import torch

from weaklysuperviseddl_tpu_torch.config import AlternatingConfig, ExperimentConfig, RefineConfig
from weaklysuperviseddl_tpu_torch.data.mask_store import MaskStore
from weaklysuperviseddl_tpu_torch.data.preprocess import preprocess_batch
from weaklysuperviseddl_tpu_torch.ops.resize import resize_nearest
from weaklysuperviseddl_tpu_torch.train.refine import refine_from_soft_predictions
from weaklysuperviseddl_tpu_torch.train.segmentation import (
    SegTrainState,
    _normalize_images,
    train_segmentation_model,
)
from weaklysuperviseddl_tpu_torch.utils.checkpoint import save_alternation
from weaklysuperviseddl_tpu_torch.utils.profiling import Stopwatch


def _sweep_index_table(n: int, batch_size: int) -> np.ndarray:
    """Sequential [T, B] index table over all n masks (ref :803-810 walks the
    train set in order); the ragged tail repeats the last index."""
    T = (n + batch_size - 1) // batch_size
    idx = np.concatenate([np.arange(n), np.repeat(n - 1, T * batch_size - n)])
    return idx.reshape(T, batch_size).astype(np.int64)


def make_refine_sweep(model: torch.nn.Module, cfg: RefineConfig, seg_size: int = 256):
    """One refinement sweep over the resident store: returns
    ``sweep(dev_masks, dev_images, idx_table) -> summed loss`` (a 0-dim
    tensor), which updates ``dev_masks`` in place."""

    @torch.no_grad()
    def sweep(dev_masks: torch.Tensor, dev_images: torch.Tensor, idx_table: torch.Tensor):
        model.eval()
        total = torch.zeros((), device=dev_masks.device)
        for idx in idx_table:
            x, _ = preprocess_batch(dev_images[idx], None, size=seg_size)
            x = _normalize_images(x)
            m = dev_masks[idx].to(torch.int32)
            S = torch.softmax(model(x.permute(0, 3, 1, 2)), dim=1).permute(0, 2, 3, 1)
            refined, loss = refine_from_soft_predictions(
                S.contiguous(), x.contiguous(), m,
                lambda_boundary=cfg.lambda_boundary, threshold=cfg.threshold, lr=cfg.lr,
                num_steps=cfg.num_steps, sigma_color=cfg.sigma_color,
                sigma_space=cfg.sigma_space, window_size=cfg.window_size, loss=cfg.loss,
                use_pallas=cfg.use_pallas)
            dev_masks[idx] = refined.to(dev_masks.dtype)
            total = total + loss
        return total

    return sweep


def upload_store_resident(store: MaskStore, seg_size: int = 256, device=None):
    """One upload of the store: raw uint8 images and masks nearest-resized
    (half-pixel centres) to ``seg_size``, the resolution refinement runs at
    and writes back. Returns (images, masks, keys)."""
    images, masks, keys = store.as_arrays()
    dev_images = torch.from_numpy(images).to(device)
    dev_masks = torch.from_numpy(masks.astype(np.uint8)).to(device)
    if dev_masks.shape[1] != seg_size or dev_masks.shape[2] != seg_size:
        dev_masks = resize_nearest(dev_masks, (seg_size, seg_size), torch_legacy=False,
                                   axes=(1, 2)).contiguous()
    return dev_images, dev_masks, keys


def refine_store(model: torch.nn.Module, store: MaskStore, cfg: RefineConfig,
                 seg_size: int = 256, batch_size: int = 8, num_sweeps: int = 1) -> float:
    """``num_sweeps`` sweeps over every mask of the store, written back once."""
    dev = next(model.parameters()).device
    dev_images, dev_masks, keys = upload_store_resident(store, seg_size, dev)
    sweep = make_refine_sweep(model, cfg, seg_size)
    idx_table = torch.from_numpy(_sweep_index_table(len(keys), batch_size)).to(dev)
    total = 0.0
    for _ in range(num_sweeps):
        total += float(sweep(dev_masks, dev_images, idx_table))
    for j, k in enumerate(keys):
        store.update_mask(k, dev_masks[j].cpu().numpy())
    return total


def run_alternating_training(state: SegTrainState, store: MaskStore, cfg: ExperimentConfig,
                             eval_fn=None, eval_images: int = 0,
                             checkpoint_dir: str | None = None, start_iteration: int = 0,
                             stopwatch: Stopwatch | None = None,
                             trajectory: list | None = None, log=print):
    """Outer alternating loop over alternations ``start_iteration`` to
    ``num_alternations - 1``. ``eval_fn(state) -> (iou, acc)`` runs once per
    alternation; with ``trajectory`` a list, each alternation's IoU/acc is
    appended. With ``checkpoint_dir``, each alternation is snapshotted there
    after its masks are written back. ``stopwatch`` times the phases of this
    loop."""
    sw = stopwatch if stopwatch is not None else Stopwatch()
    alt: AlternatingConfig = cfg.alternating
    seg_size = cfg.data.seg_size
    dev = next(state.model.parameters()).device
    dev_images, dev_masks, keys = upload_store_resident(store, seg_size, dev)
    sweep = make_refine_sweep(state.model, alt.refine, seg_size)
    idx_table = torch.from_numpy(_sweep_index_table(len(keys), cfg.seg.batch_size)).to(dev)
    n_store = len(keys)

    for iteration in range(start_iteration, alt.num_alternations):
        with sw.phase("seg_training", images=n_store * alt.epochs_per_round):
            state, _ = train_segmentation_model(
                state, dev_images, dev_masks, loss_fn=cfg.seg.loss_fn,
                num_epochs=alt.epochs_per_round, batch_size=cfg.seg.batch_size,
                seg_size=seg_size, seed=cfg.seed + iteration, run_id=f"alt{iteration}",
                log=log)
        if eval_fn is not None:
            with sw.phase("eval", images=eval_images):
                avg_iou, avg_acc = eval_fn(state)
            if trajectory is not None:
                trajectory.append({"alternation": iteration + 1, "iou": round(avg_iou, 4),
                                   "acc": round(avg_acc, 4)})
            log(f"Iteration {iteration + 1}: Evaluation -> "
                f"Mean IoU: {avg_iou:.4f}, Mean Acc: {avg_acc:.4f}")
        with sw.phase("refinement_sweeps", images=n_store * alt.refine_repeats):
            for _ in range(alt.refine_repeats):
                sweep(dev_masks, dev_images, idx_table)
        with sw.phase("store_sync", images=n_store):
            masks_np = dev_masks.cpu().numpy()
            for j, k in enumerate(keys):
                store.update_mask(k, masks_np[j])
        if checkpoint_dir is not None:
            with sw.phase("checkpoint"):
                save_alternation(checkpoint_dir, iteration, state, store)
    log("Alternating training and pseudo mask updates completed.")
    return state, store
