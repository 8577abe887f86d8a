"""The ablation grid (port of weaklysuperviseddl_tpu/pipelines/ablations.py).

Reference: TraditionalModel/Abalations.py:9-96: a grid over (cam_method,
cam_thresh, alpha, lr, keep_largest) × repeats; per grid point, pseudo-masks
from the classifier's CAMs, DeepLabV3 trained on them for ``seg.epochs`` and
evaluated on the test set; mean and stdev per combination.

As in the JAX package, the CAMs depend only on alpha (the grid holds the
target layers fixed), so they are extracted once per alpha and each grid
point derives its masks from them (``masks_from_cams``) in the shuffled
order the reference's per-run loader would give for that repeat; the test
set is uploaded once and evaluated by ``evaluate_segmentation_dataset``.
``run_ablation`` without the extracted CAMs takes the reference's shape
(pseudo-masks and evaluation from loaders).

``run_key(base_seed, run_id)`` seeds each run's DeepLabV3 and its training
(dropout and batch order): a pure function of both arguments in any
process. The JAX package seeds the initial weights from its key and trains
every run with the default seed 0. Each run's DeepLabV3 computes in float32
whatever ``seg.dtype`` says, as the JAX package's grid does; the classifier
is the caller's, in its own compute dtype.
"""

from __future__ import annotations

import itertools
import zlib

import numpy as np

from weaklysuperviseddl_tpu_torch.config import ExperimentConfig
from weaklysuperviseddl_tpu_torch.data.dataset import load_split_data
from weaklysuperviseddl_tpu_torch.data.loader import batches
from weaklysuperviseddl_tpu_torch.masks.pseudo import (
    extract_cams,
    generate_pseudo_masks,
    masks_from_cams,
)
from weaklysuperviseddl_tpu_torch.pipelines.weakly import (
    build_seg_model,
    check_supported,
    load_test_arrays,
)
from weaklysuperviseddl_tpu_torch.train.segmentation import (
    _splitmix64,
    create_seg_state,
    evaluate_segmentation,
    evaluate_segmentation_dataset,
    train_segmentation_model,
)
from weaklysuperviseddl_tpu_torch.utils.metrics import mean_std


def run_key(base_seed: int, run_id: str) -> int:
    """A run's integer seed from ``base_seed`` and ``zlib.crc32(run_id)``.
    Python's ``hash(str)`` is salted per process (PYTHONHASHSEED); CRC32 is a
    fixed function of the bytes, so a grid record can be reproduced in any
    process."""
    return _splitmix64((base_seed << 32) ^ zlib.crc32(run_id.encode()))


def run_ablation(classifier_model, train_loader, test_loader, cam_method: str,
                 cam_thresh: float, alpha: float, lr: float, keep_largest: bool, run_id: str,
                 cfg: ExperimentConfig, log=print, resident_cams=None, mask_order=None,
                 test_arrays=None):
    """One grid point (ref Abalations.py:9-29); returns its result dict.

    ``resident_cams``/``mask_order``: CAMs from ``extract_cams`` and this
    repeat's shuffled order; without them the pseudo-masks come from
    ``train_loader``. ``test_arrays``: (images uint8, trimaps uint8) on the
    device; without them the evaluation runs over ``test_loader()``."""
    del cam_method  # LayerCAM is the only method the reference grid enables
    d = cfg.data
    dev = next(classifier_model.parameters()).device
    if resident_cams is not None:
        store = masks_from_cams(resident_cams, cam_thresh=cam_thresh,
                                keep_largest_masks=keep_largest, order=mask_order,
                                max_images=cfg.mask.max_images)
    else:
        store = generate_pseudo_masks(
            train_loader, classifier_model, cam_thresh=cam_thresh, alpha=alpha,
            keep_largest_masks=keep_largest, run_id=run_id,
            target_layers=cfg.cam.target_layers, alpha_mode=cfg.cam.alpha_mode,
            image_size=d.image_size, max_images=cfg.mask.max_images)
    key = run_key(d.seed, run_id)
    state = create_seg_state(build_seg_model(cfg), seed=key, lr=lr, device=dev)
    images, masks, _ = store.as_arrays()
    state, final_loss = train_segmentation_model(
        state, images, masks, loss_fn=cfg.seg.loss_fn, num_epochs=cfg.seg.epochs,
        batch_size=cfg.seg.batch_size, seg_size=d.seg_size, seed=key, run_id=run_id, log=log)
    if test_arrays is not None:
        iou, acc = evaluate_segmentation_dataset(
            state.model, *test_arrays, batch_size=d.eval_batch_size, seg_size=d.seg_size,
            eval_size=d.image_size)
    else:
        iou, acc = evaluate_segmentation(state.model, test_loader(), seg_size=d.seg_size,
                                         eval_size=d.image_size)
    return {"run_id": run_id, "iou": iou, "acc": acc, "final_loss": final_loss}


def run_ablation_experiment(all_combinations, classifier_model, cfg: ExperimentConfig,
                            num_repeats: int = 3, log=print):
    """Grid × repeats with mean/stdev summaries (ref Abalations.py:32-81): one
    result dict per run, then one summary per combination. The classifier's
    device is the run's."""
    check_supported(cfg)
    d = cfg.data
    dev = next(classifier_model.parameters()).device
    train_ds, _ = load_split_data(
        d.root, train_ratio=d.train_ratio, seed=d.seed, synthetic_size=d.synthetic_size,
        image_size=d.image_size, num_classes=d.num_classes)
    test_arrays = load_test_arrays(cfg, dev)

    # the loader's shuffle order per repeat (data/loader.batches); max_images
    # caps the shuffled stream, so masks_from_cams caps after ordering
    n_train = len(train_ds)
    repeat_orders = []
    for repeat in range(num_repeats):
        order = np.arange(n_train)
        np.random.default_rng(repeat).shuffle(order)
        repeat_orders.append(order)

    cams_by_alpha: dict = {}

    def resident_for(alpha):
        if alpha not in cams_by_alpha:
            log(f"Extracting CAMs once for alpha={alpha} ({n_train} images)...")
            cams_by_alpha[alpha] = extract_cams(
                batches(train_ds, d.batch_size, pad_to_full=True), classifier_model,
                alpha=alpha, target_layers=cfg.cam.target_layers,
                alpha_mode=cfg.cam.alpha_mode, image_size=d.image_size, max_images=None)
        return cams_by_alpha[alpha]

    results = []
    for combo_id, (method, cam_thresh, alpha, lr, keep_largest_opt) in enumerate(all_combinations):
        run_results = []
        for repeat in range(num_repeats):
            run_id = f"abl_{combo_id:03d}_r{repeat}"
            log(f"\n Running {run_id}...")
            result = run_ablation(
                classifier_model, train_loader=None, test_loader=None, cam_method=method,
                cam_thresh=cam_thresh, alpha=alpha, lr=lr, keep_largest=keep_largest_opt,
                run_id=run_id, cfg=cfg, log=log, resident_cams=resident_for(alpha),
                mask_order=repeat_orders[repeat], test_arrays=test_arrays)
            result.update({"cam_method": method, "cam_thresh": cam_thresh, "alpha": alpha,
                           "learning_rate": lr, "keep_largest": keep_largest_opt})
            results.append(result)
            run_results.append(result)

        iou_m, iou_s = mean_std(r["iou"] for r in run_results)
        acc_m, acc_s = mean_std(r["acc"] for r in run_results)
        loss_m, loss_s = mean_std(r["final_loss"] for r in run_results)
        results.append({
            "combo_id": combo_id, "cam_method": method, "cam_thresh": cam_thresh,
            "alpha": alpha, "learning_rate": lr, "keep_largest": keep_largest_opt,
            "iou_mean": iou_m, "iou_std": iou_s, "acc_mean": acc_m, "acc_std": acc_s,
            "loss_mean": loss_m, "loss_std": loss_s,
        })
    return results


def default_grid():
    """The reference's grid (Abalations.py:86-95)."""
    cam_methods = ["LayerCAM"]
    cam_thresholds = [0.3, 0.5, 0.7]
    alphas = [1.0]
    lrs = [1e-2, 1e-3, 1e-4, 1e-5]
    keep_largest_opts = [True]
    return list(itertools.product(cam_methods, cam_thresholds, alphas, lrs, keep_largest_opts))
