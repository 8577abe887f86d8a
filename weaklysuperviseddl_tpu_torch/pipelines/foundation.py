"""Foundation-model zero-shot baseline: GroundingDINO boxes → SAM masks (port of
weaklysuperviseddl_tpu/pipelines/foundation.py).

Reference: FoundationModel/two_stage_foundation.py — zero-shot detection with
prompts ("a cat", "a dog") (box threshold 0.3, text 0.25), the boxes prompt
SAM-ViT-base, ``pred_masks[:, 0]`` → channel max > 0.5 → 224² nearest
binary mask; evaluation against trimap ∈ {1, 3}; masks and a three-panel
figure saved.

Both models are the port's own (``models/sam``, ``models/gdino``) with
``transformers``' state-dict keys, and run on the card unless ``device``
asks for the CPU. A builder with ``config=`` makes the model with random
weights drawn from ``generator`` (torch's default generator when None);
with a hub name it reads the local Hugging Face cache through
``models/foundation_import.py`` and raises where the snapshot is missing.
The processors are ``data/foundation_preprocess.py`` and
``data/wordpiece.py``.

The JAX package's quirks stay: ``segment`` returns the first box's three
masks only (every box still goes through SAM); the channel max of SAM's raw
low-resolution logits is thresholded at 0.5 (no sigmoid); that 256² map
covers the padded 1024² frame and is resized straight to the output size.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from weaklysuperviseddl_tpu_torch.data.foundation_preprocess import (
    as_image_tensor,
    gdino_preprocess,
    sam_preprocess,
)
from weaklysuperviseddl_tpu_torch.data.wordpiece import WordPieceTokenizer
from weaklysuperviseddl_tpu_torch.device import resolve_device
from weaklysuperviseddl_tpu_torch.models import foundation_import
from weaklysuperviseddl_tpu_torch.models.foundation_config import (  # noqa: F401
    tiny_gdino_config,
    tiny_gdino_vocab,
    tiny_sam_config,
)
from weaklysuperviseddl_tpu_torch.models.gdino import GroundingDinoForObjectDetection
from weaklysuperviseddl_tpu_torch.models.gdino.postprocess import grounded_boxes
from weaklysuperviseddl_tpu_torch.models.sam import SamModel
from weaklysuperviseddl_tpu_torch.ops.resize import resize_nearest

DEFAULT_PROMPTS = ("a cat", "a dog")


def init_weights(model: nn.Module, generator: torch.Generator | None = None,
                 std: float = 0.02) -> nn.Module:
    """Random weights in ``transformers``' scheme, drawn from ``generator``:
    linear, convolution and embedding weights N(0, std²) with zero biases,
    norms at 1 and 0, GroundingDINO's level embeddings N(0, 1) and SAM's
    Fourier matrix N(0, 1)·hidden/2; the relative-position tables, SAM's
    absolute position embedding and the fusion scales keep their
    constructor values."""
    def normal(t, s):
        with torch.no_grad():
            t.copy_(torch.randn(t.shape, generator=generator, dtype=t.dtype) * s)

    for name, m in model.named_modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d, nn.Embedding)):
            normal(m.weight, std)
            if getattr(m, "bias", None) is not None:
                nn.init.zeros_(m.bias)
            if isinstance(m, nn.Embedding) and m.padding_idx is not None:
                with torch.no_grad():
                    m.weight[m.padding_idx].zero_()
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
        if hasattr(m, "level_embed"):
            normal(m.level_embed, 1.0)
        if name.endswith("shared_image_embedding"):
            normal(m.positional_embedding, m.scale)
    if hasattr(model, "tie_weights"):
        model.tie_weights()
    return model


class GroundingDinoDetector:
    """``detect(image, prompts) → boxes [N, 4]`` float32 numpy (x0, y0, x1, y1)
    in the image's pixels, the queries scoring above ``box_threshold`` in
    query order."""

    def __init__(self, model, tokenizer, size: dict, box_threshold: float,
                 text_threshold: float, device):
        self.model, self.tokenizer, self.size = model, tokenizer, size
        self.box_threshold, self.text_threshold = box_threshold, text_threshold
        self.device = device

    def preprocess(self, image, prompts) -> dict[str, torch.Tensor]:
        pixel_values, pixel_mask = gdino_preprocess(image, self.size["shortest_edge"],
                                                    self.size["longest_edge"], self.device)
        enc = self.tokenizer.encode(list(prompts) if not isinstance(prompts, str) else prompts)
        text = {k: torch.tensor([v], dtype=torch.int64, device=self.device)
                for k, v in enc.items()}
        return {"pixel_values": pixel_values, "pixel_mask": pixel_mask, **text}

    def raw(self, image, prompts):
        """(logits [1, Q, max_text_len], pred_boxes [1, Q, 4])."""
        inputs = self.preprocess(image, prompts)
        with torch.no_grad():
            return self.model(inputs["pixel_values"], inputs["input_ids"],
                              inputs["token_type_ids"], inputs["attention_mask"],
                              inputs["pixel_mask"])

    def postprocess(self, logits, pred_boxes, image_hw) -> np.ndarray:
        return grounded_boxes(logits, pred_boxes, self.box_threshold, image_hw).cpu().numpy()

    def __call__(self, image, prompts) -> np.ndarray:
        image = as_image_tensor(image, self.device)
        logits, boxes = self.raw(image, prompts)
        return self.postprocess(logits, boxes, tuple(image.shape[:2]))


class SamSegmenter:
    """``segment(image, boxes) → [3, 4h, 4w]`` float32 numpy: the first box's
    three low-resolution mask logits (every box is decoded)."""

    def __init__(self, model, image_size: int, device):
        self.model, self.image_size, self.device = model, image_size, device

    def preprocess(self, image, boxes):
        return sam_preprocess(image, boxes, self.image_size, self.image_size, self.device)

    def raw(self, image, boxes):
        """(iou_scores [1, N, 3], pred_masks [1, N, 3, 4h, 4w])."""
        pixel_values, input_boxes = self.preprocess(image, boxes)
        with torch.no_grad():
            return self.model(pixel_values, input_boxes)

    def __call__(self, image, boxes) -> np.ndarray:
        _, masks = self.raw(image, boxes)
        return masks[:, 0].cpu().numpy().squeeze(0)


def hf_detector(model_name: str = "IDEA-Research/grounding-dino-base",
                box_threshold: float = 0.3, text_threshold: float = 0.25,
                config=None, vocab=None, device=None,
                generator: torch.Generator | None = None) -> GroundingDinoDetector:
    """GroundingDINO zero-shot detector (ref two_stage_foundation.py:31-56).

    ``config`` (a ``GroundingDinoConfig``) + ``vocab`` (a token list; the
    JAX package's 11-token list when None): random weights from
    ``generator``, processor size from ``config.image_processor_size``.
    Otherwise ``model_name``'s local snapshot (config, weights, vocab.txt).
    """
    device = resolve_device(device)
    if config is not None:
        vocab = tiny_gdino_vocab() if vocab is None else vocab
        if len(vocab) != config.text_config.vocab_size:
            raise ValueError(f"vocab size {len(vocab)} != config.text_config.vocab_size "
                             f"{config.text_config.vocab_size}")
        model = init_weights(GroundingDinoForObjectDetection(config), generator)
    else:
        snap = foundation_import.snapshot_dir(model_name, ("config.json", "model.safetensors",
                                                           "vocab.txt"))
        config, state, vocab = foundation_import.gdino_from_snapshot(snap)
        model = foundation_import.load_weights(GroundingDinoForObjectDetection(config), state)
        vocab = str(vocab)
    return GroundingDinoDetector(model.eval().to(device), WordPieceTokenizer(vocab),
                                 config.image_processor_size, box_threshold, text_threshold,
                                 device)


def hf_segmenter(model_name: str = "facebook/sam-vit-base", config=None,
                 image_size: int | None = None, device=None,
                 generator: torch.Generator | None = None) -> SamSegmenter:
    """SAM box-prompted segmenter (ref two_stage_foundation.py:34-66).

    ``config`` (a ``SamConfig``): random weights from ``generator``;
    ``image_size`` must equal ``config.vision_config.image_size`` when
    given. Otherwise ``model_name``'s local snapshot.
    """
    device = resolve_device(device)
    if config is not None:
        size = image_size or config.vision_config.image_size
        if size != config.vision_config.image_size:
            raise ValueError(
                f"image_size {size} != config.vision_config.image_size "
                f"{config.vision_config.image_size}: the vision encoder's position "
                f"embeddings are sized for the config value")
        model = init_weights(SamModel(config), generator)
    else:
        if image_size is not None:
            raise ValueError("image_size only applies with config=; the pretrained "
                             "processor carries its own sizing")
        config, state = foundation_import.sam_from_snapshot(
            foundation_import.snapshot_dir(model_name))
        model = foundation_import.load_weights(SamModel(config), state)
    model = model.eval().to(device)
    model.tie_weights()
    return SamSegmenter(model, config.vision_config.image_size, device)


# ---------------------------------------------------------------------------
# orchestration (reference semantics, backend-agnostic)
# ---------------------------------------------------------------------------

def convert_3channel_to_mask(image_3ch, threshold: float = 0.5):
    """Channel max > threshold (ref :39-42)."""
    gray = np.max(np.asarray(image_3ch), axis=0)
    return (gray > threshold).astype(np.uint8)


def calculate_iou_and_accuracy(pred_mask, true_mask):
    """Reference :89-97."""
    pred_mask = np.asarray(pred_mask)
    true_mask = np.asarray(true_mask)
    intersection = np.logical_and(pred_mask, true_mask).sum()
    union = np.logical_or(pred_mask, true_mask).sum()
    iou = intersection / union if union != 0 else 1.0
    pixel_accuracy = (pred_mask == true_mask).sum() / pred_mask.size
    return iou, pixel_accuracy


def _resize_mask(mask: np.ndarray, size: int) -> np.ndarray:
    out = resize_nearest(torch.from_numpy(np.ascontiguousarray(mask)), (size, size),
                         torch_legacy=False)
    return out.numpy().astype(np.uint8)


class FoundationPipeline:
    def __init__(self, detector=None, segmenter=None, output_size: int = 224, device=None):
        """Missing backends are the hub models, read from the local cache
        onto ``device`` (None: the card)."""
        self.detector = detector if detector is not None else hf_detector(device=device)
        self.segmenter = segmenter if segmenter is not None else hf_segmenter(device=device)
        self.output_size = output_size

    def run_segmentation_pipeline(self, image, prompts=DEFAULT_PROMPTS):
        """Reference :44-74. image: PIL or HWC uint8 array. Returns the
        ``output_size``² binary mask, or None when nothing is detected."""
        boxes = self.detector(image, prompts)
        if boxes is None or len(boxes) == 0:
            return None
        masks = np.asarray(self.segmenter(image, boxes), np.float32)
        if masks.ndim == 2:
            masks = masks[None]
        return _resize_mask(convert_3channel_to_mask(masks), self.output_size)


class _MaskWriter:
    """mask_{idx}.png through the native PNG writer (PIL where it cannot be
    built), and the three-panel figure where matplotlib is installed."""

    def __init__(self, save_dir: str, log):
        from weaklysuperviseddl_tpu_torch.data.mask_store import _native_io

        os.makedirs(save_dir, exist_ok=True)
        self.save_dir, self.native = save_dir, _native_io()
        try:
            import matplotlib  # noqa: F401
            self.figures = True
        except ImportError:
            self.figures = False
            log("WARNING: matplotlib is not installed; the viz_*.png figures are not written")

    def write(self, idx: int, image, gt_bin, pred_mask):
        path = os.path.join(self.save_dir, f"mask_{idx}.png")
        png = (pred_mask * 255).astype(np.uint8)
        if self.native is not None:
            self.native.png_write_async(path, png)
        else:
            from PIL import Image

            Image.fromarray(png).save(path)
        if self.figures:
            _save_viz(image, gt_bin, pred_mask, os.path.join(self.save_dir, f"viz_{idx}.png"))

    def flush(self):
        if self.native is not None:
            self.native.io_flush()


def evaluate_pipeline_on_dataset(dataset, pipeline: FoundationPipeline,
                                 num_images: int = 100, save_outputs: bool = True,
                                 save_dir: str = "pseudo_masks",
                                 prompts=DEFAULT_PROMPTS, log=print):
    """Reference :99-149: per-image IoU/accuracy against trimap ∈ {1, 3};
    saves masks and the three-panel figure; logs running and final averages."""
    iou_scores, acc_scores = [], []
    writer = _MaskWriter(save_dir, log) if save_outputs else None
    size = pipeline.output_size
    n = min(num_images, len(dataset))
    try:
        for idx in range(n):
            image, (_, trimap) = dataset[idx]
            gt_bin = np.isin(np.asarray(trimap), [1, 3]).astype(np.uint8)
            if gt_bin.shape != (size, size):
                gt_bin = _resize_mask(gt_bin, size)
            pred_mask = pipeline.run_segmentation_pipeline(image, prompts)
            if pred_mask is None:
                log(f"Image {idx}: No prediction made")
                continue
            iou, acc = calculate_iou_and_accuracy(pred_mask, gt_bin)
            iou_scores.append(iou)
            acc_scores.append(acc)
            log(f"[{idx + 1}/{n}] IoU: {iou:.4f}, Accuracy: {acc:.4f}")
            if writer is not None:
                writer.write(idx, image, gt_bin, pred_mask)
    finally:
        if writer is not None:
            writer.flush()
    avg_iou = float(np.mean(iou_scores)) if iou_scores else 0.0
    avg_acc = float(np.mean(acc_scores)) if acc_scores else 0.0
    log("\n--- Final Evaluation ---")
    log(f"Average IoU over {len(iou_scores)} images: {avg_iou:.4f}")
    log(f"Average Pixel Accuracy: {avg_acc:.4f}")
    return avg_iou, avg_acc


def _save_viz(image, gt_bin, pred_mask, path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axs = plt.subplots(1, 3, figsize=(12, 4))
    axs[0].imshow(np.asarray(image))
    axs[0].set_title("Original Image")
    axs[1].imshow(gt_bin, cmap="gray")
    axs[1].set_title("Ground Truth")
    axs[2].imshow(pred_mask, cmap="gray")
    axs[2].set_title("Predicted Mask")
    for ax in axs:
        ax.axis("off")
    plt.tight_layout()
    plt.savefig(path)
    plt.close(fig)
