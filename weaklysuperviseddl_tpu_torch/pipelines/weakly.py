"""The weakly-supervised cycle: classify → LayerCAM → pseudo-masks → segment,
then the alternating train ↔ refine loop (port of
weaklysuperviseddl_tpu/pipelines/weakly.py; ref AlternatingDirectionCutLoss.py:468-821).

Every entry point runs on the card unless ``device="cpu"`` is given, and
raises without a card. The port runs on one device: a ``MeshConfig`` other
than data ∈ {-1, 1}, model == 1 raises. ``mask.use_crf`` runs the dense CRF
with the "attention" or "subsampled" backend (the bilateral filter is a CUDA
kernel on the card); ``seg.loss_fn`` is "cross_entropy" or "lovasz_softmax";
``seg.bn_frozen`` trains DeepLabV3 with frozen BatchNorm statistics. With a
``checkpoint_dir`` the alternating loop snapshots every alternation there,
and ``resume=True`` continues from the latest snapshot
(``utils/checkpoint.py``). ``classifier_weights`` and ``seg_weights`` start
the cycle from given state dicts (for instance a JAX tree's, carried across by
``models/jax_import.py``) instead of the seeded ``init_weights``.

``classifier.dtype`` and ``seg.dtype`` ("float32" or "bfloat16") are the two
models' compute dtypes, on the resume path too, as in the JAX package:
parameters, BatchNorm statistics, Adam's state and snapshots stay float32;
the CAMs, DeepLabV3's logits, the losses, the refinement's inputs and the
CRF's stay float32. The supervised baseline and the ablation grid build
DeepLabV3 in float32 whatever ``seg.dtype`` says, as JAX's do. Not ported
yet: the CRF's other backends.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch

from weaklysuperviseddl_tpu_torch.config import ExperimentConfig
from weaklysuperviseddl_tpu_torch.data.dataset import download_data, load_split_data
from weaklysuperviseddl_tpu_torch.data.loader import batches, stack_dataset
from weaklysuperviseddl_tpu_torch.device import resolve_device
from weaklysuperviseddl_tpu_torch.masks.densecrf import EXACT_BACKENDS
from weaklysuperviseddl_tpu_torch.masks.pseudo import generate_pseudo_masks
from weaklysuperviseddl_tpu_torch.models.classifier import CamClassifier
from weaklysuperviseddl_tpu_torch.models.deeplabv3 import DeepLabV3
from weaklysuperviseddl_tpu_torch.models.resnet import init_weights
from weaklysuperviseddl_tpu_torch.train.alternating import run_alternating_training
from weaklysuperviseddl_tpu_torch.train.classifier import train_fc_only
from weaklysuperviseddl_tpu_torch.train.segmentation import (
    LOSSES,
    create_seg_state,
    evaluate_segmentation_dataset,
    train_segmentation_model,
)
from weaklysuperviseddl_tpu_torch.utils.checkpoint import latest_alternation, restore_alternation
from weaklysuperviseddl_tpu_torch.utils.profiling import Stopwatch


@dataclass
class WeaklySupervisedResult:
    classifier: Any
    seg_state: Any
    mask_store: Any
    metrics: dict = field(default_factory=dict)
    test_arrays: Any = None


def check_supported(cfg: ExperimentConfig):
    """Raise on the parts of the config the port does not run yet."""
    if cfg.mesh.data not in (-1, 1) or cfg.mesh.model != 1:
        raise ValueError(f"the port runs on one device; MeshConfig {cfg.mesh} needs "
                         "parallel/mesh.py, which is not ported yet")
    if cfg.seg.loss_fn not in LOSSES:
        raise ValueError(f"unknown seg.loss_fn {cfg.seg.loss_fn!r}; expected one of {LOSSES}")
    if cfg.mask.use_crf and cfg.mask.crf_backend not in EXACT_BACKENDS:
        raise NotImplementedError(f"mask.crf_backend={cfg.mask.crf_backend!r} is not ported "
                                  f"yet; the port runs {EXACT_BACKENDS}")


def crf_kwargs(cfg: ExperimentConfig) -> dict | None:
    """The dense CRF's arguments from ``cfg.mask`` (None when the CRF is off)."""
    m = cfg.mask
    if not m.use_crf:
        return None
    return dict(gauss_sxy=m.crf_gaussian_sxy, gauss_compat=m.crf_gaussian_compat,
                bilat_sxy=m.crf_bilateral_sxy, bilat_srgb=m.crf_bilateral_srgb,
                bilat_compat=m.crf_bilateral_compat, n_iters=m.crf_iters,
                bilat_backend=m.crf_backend, key_stride=m.crf_key_stride)


def build_classifier(cfg: ExperimentConfig, device, weights: dict | None = None) -> CamClassifier:
    """The CAM classifier on ``device`` in ``classifier.dtype``: the state
    dict ``weights`` where given, else seeded random weights."""
    model = CamClassifier(num_classes=cfg.data.num_classes, depth=cfg.classifier.depth,
                          width_multiplier=cfg.classifier.width_multiplier,
                          dilate_layer4=cfg.classifier.dilate_layer4,
                          dtype=cfg.classifier.dtype)
    if weights is None:
        init_weights(model, torch.Generator().manual_seed(cfg.seed))
    else:
        model.load_state_dict(weights, strict=True)
    return model.to(device)


def build_seg_model(cfg: ExperimentConfig, dtype: str = "float32") -> DeepLabV3:
    """DeepLabV3 from ``cfg.seg`` in the compute ``dtype``: the cycle passes
    ``seg.dtype``; the supervised baseline and the ablation grid keep the
    default, as the JAX package's do."""
    return DeepLabV3(num_classes=cfg.seg.num_classes, backbone_depth=cfg.seg.backbone_depth,
                     width_multiplier=cfg.seg.width_multiplier, bn_frozen=cfg.seg.bn_frozen,
                     dtype=dtype)


def load_test_arrays(cfg: ExperimentConfig, device):
    """The test split stacked once and uploaded: (images uint8, trimaps uint8)."""
    d = cfg.data
    test_ds = download_data(d.root, split="test", synthetic_size=max(16, d.synthetic_size // 4),
                            image_size=d.image_size, seed=d.seed, num_classes=d.num_classes)
    test_images, _, test_trimaps = stack_dataset(test_ds)
    return (torch.from_numpy(test_images).to(device),
            torch.from_numpy(test_trimaps).to(device))


def run_weakly_supervised(cfg: ExperimentConfig, log=print, stopwatch: Stopwatch | None = None,
                          device=None, classifier_weights: dict | None = None,
                          seg_weights: dict | None = None) -> WeaklySupervisedResult:
    """The weakly-supervised cycle at the configured scale: trained models,
    the pseudo-mask store and the eval metrics. ``stopwatch`` times each
    stage of this code path in place. ``classifier_weights`` and
    ``seg_weights`` (state dicts) replace the seeded initial weights of the
    classifier and of DeepLabV3."""
    check_supported(cfg)
    dev = resolve_device(device)
    sw = stopwatch if stopwatch is not None else Stopwatch(dev)
    d = cfg.data
    with sw.phase("data", images=d.synthetic_size):
        train_ds, val_ds = load_split_data(
            d.root, train_ratio=d.train_ratio, seed=d.seed, synthetic_size=d.synthetic_size,
            image_size=d.image_size, num_classes=d.num_classes)
        test_arrays = load_test_arrays(cfg, dev)

    # --- stage 1: frozen-backbone classifier ---------------------------------
    model = build_classifier(cfg, dev, classifier_weights)
    log("Starting training...")
    with sw.phase("classifier_fc_training", images=len(train_ds) * cfg.classifier.epochs):
        train_fc_only(
            model,
            train_loader_fn=lambda: batches(train_ds, d.batch_size, shuffle=True, seed=d.seed,
                                            pad_to_full=True),
            val_loader_fn=lambda: batches(val_ds, d.eval_batch_size),
            epochs=cfg.classifier.epochs, lr=cfg.classifier.lr, num_classes=d.num_classes,
            image_size=d.image_size, interpolation=d.interpolation, log=log)
    log(" Classifier trained.")

    # --- stage 2+3: LayerCAM → pseudo-masks ----------------------------------
    with sw.phase("pseudo_mask_generation", images=min(cfg.mask.max_images, len(train_ds))):
        store = generate_pseudo_masks(
            batches(train_ds, d.batch_size, pad_to_full=True), model,
            cam_thresh=cfg.mask.cam_thresh, alpha=cfg.cam.alpha,
            keep_largest_masks=cfg.mask.keep_largest, target_layers=cfg.cam.target_layers,
            alpha_mode=cfg.cam.alpha_mode, image_size=d.image_size,
            max_images=cfg.mask.max_images, store_dir=cfg.mask.store_dir,
            use_crf=cfg.mask.use_crf, crf_kwargs=crf_kwargs(cfg))
    log(f"Pseudo masks generated: {len(store)}")

    # --- stage 4: DeepLabV3 on the pseudo-masks -------------------------------
    seg_state = create_seg_state(build_seg_model(cfg, cfg.seg.dtype), seed=cfg.seed + 1,
                                 lr=cfg.seg.lr, device=dev)
    if seg_weights is not None:
        seg_state.model.load_state_dict(seg_weights, strict=True)
    images, masks, _ = store.as_arrays()
    with sw.phase("seg_training", images=len(store) * cfg.seg.epochs):
        seg_state, final_loss = train_segmentation_model(
            seg_state, images, masks, loss_fn=cfg.seg.loss_fn, num_epochs=cfg.seg.epochs,
            batch_size=cfg.seg.batch_size, seg_size=d.seg_size, seed=cfg.seed, log=log)

    # --- stage 5: eval against the true trimaps ------------------------------
    with sw.phase("eval", images=int(test_arrays[0].shape[0])):
        avg_iou, avg_acc = evaluate_segmentation_dataset(
            seg_state.model, *test_arrays, batch_size=d.eval_batch_size, seg_size=d.seg_size,
            eval_size=d.image_size, log=log)
    metrics = {"iou": avg_iou, "acc": avg_acc, "final_loss": final_loss}
    return WeaklySupervisedResult(model, seg_state, store, metrics, test_arrays)


def run_weakly_supervised_alternating(cfg: ExperimentConfig, checkpoint_dir: str | None = None,
                                      resume: bool = False, stopwatch: Stopwatch | None = None,
                                      log=print, device=None,
                                      classifier_weights: dict | None = None,
                                      seg_weights: dict | None = None) -> WeaklySupervisedResult:
    """The whole main path: the cycle above, then the alternating train ↔
    refine loop over the pseudo-mask store with an eval per alternation.

    With ``checkpoint_dir``, every alternation is snapshotted there. With
    ``resume=True`` the cycle is skipped: DeepLabV3 and its optimizer are
    built untrained, the latest snapshot in ``checkpoint_dir`` (train state
    and mask store) is restored into them, and the loop continues at the
    next alternation, as if the run had never stopped. ``classifier_weights``
    and ``seg_weights`` start the cycle as in ``run_weakly_supervised``; a
    resumed run takes its weights from the snapshot and refuses them."""
    if resume and checkpoint_dir is None:
        raise ValueError("resume=True requires checkpoint_dir (the snapshot directory "
                         "written by a previous run with --checkpoint-dir)")
    if resume and latest_alternation(checkpoint_dir) is None:
        raise FileNotFoundError(f"resume=True but no restorable alternation snapshots under "
                                f"{checkpoint_dir!r}; run without --resume to start fresh")
    if resume and (classifier_weights is not None or seg_weights is not None):
        raise ValueError("resume=True restores the weights of the latest snapshot; "
                         "initial weights apply to a fresh run only")
    check_supported(cfg)
    dev = resolve_device(device)
    sw = stopwatch if stopwatch is not None else Stopwatch(dev)
    d = cfg.data
    start_iteration = 0
    if resume:
        seg_state = create_seg_state(build_seg_model(cfg, cfg.seg.dtype), seed=cfg.seed + 1,
                                     lr=cfg.seg.lr, device=dev)
        seg_state, store, start_iteration = restore_alternation(checkpoint_dir, seg_state)
        with sw.phase("data", images=0):
            test_arrays = load_test_arrays(cfg, dev)
        log(f"Resumed from {checkpoint_dir} at alternation {start_iteration}")
        result = WeaklySupervisedResult(None, seg_state, store, {}, test_arrays)
    else:
        result = run_weakly_supervised(cfg, log=log, stopwatch=sw, device=dev,
                                       classifier_weights=classifier_weights,
                                       seg_weights=seg_weights)
    test_arrays = result.test_arrays

    def eval_fn(state):
        return evaluate_segmentation_dataset(state.model, *test_arrays,
                                             batch_size=d.eval_batch_size,
                                             seg_size=d.seg_size, eval_size=d.image_size)

    trajectory: list = []
    state, store = run_alternating_training(
        result.seg_state, result.mask_store, cfg, eval_fn=eval_fn,
        eval_images=int(test_arrays[0].shape[0]), checkpoint_dir=checkpoint_dir,
        start_iteration=start_iteration, stopwatch=sw, trajectory=trajectory, log=log)
    iou, acc = eval_fn(state)
    result.seg_state, result.mask_store = state, store
    result.metrics.update({"alt_iou": iou, "alt_acc": acc, "trajectory": trajectory})
    return result
