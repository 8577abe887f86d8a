"""BASNet saliency inference, batched (port of
weaklysuperviseddl_tpu/pipelines/basnet_infer.py).

The reference's ``PretrainedBasnetModel/RunInference.py``, per image: resize
to 256² and ImageNet-normalise → forward → ``dout`` channel 0 → min-max
``norm_pred`` → resize back to the image's size → ``{i}_saliency.png`` →
IoU and accuracy of the map > 0.5 against trimap == 1, and their means over
the first 10 test images. Here a batch runs as one forward. Weights come from
the reference's ``basnet.pth`` when the file exists, else from a seeded
random init (no download). ``build_basnet(dtype="bfloat16")`` computes in
bfloat16 with float32 parameters, as JAX's ``build_basnet(dtype=...)``, and
"float16" in float16; the maps are cast to float32 before ``norm_pred``, so
``saliency_step`` and ``run_inference`` return float32 maps in every dtype.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from weaklysuperviseddl_tpu_torch.data.loader import batches
from weaklysuperviseddl_tpu_torch.data.preprocess import normalize_images, preprocess_batch
from weaklysuperviseddl_tpu_torch.device import resolve_device
from weaklysuperviseddl_tpu_torch.models.basnet import BASNet
from weaklysuperviseddl_tpu_torch.models.resnet import init_weights
from weaklysuperviseddl_tpu_torch.ops.resize import resize_bilinear

IMG_SIZE = 256


def build_basnet(weights_path: str | None = None, device=None,
                 generator: torch.Generator | None = None, dtype: str = "float32") -> BASNet:
    """BASNet(3, 1) on ``device`` in eval mode: the state dict in
    ``weights_path`` when that file exists (the reference's ``basnet.pth``,
    read with ``weights_only=True``), else random weights drawn from
    ``generator`` (``init_weights``; seed 0 when None). ``dtype``: the
    compute dtype, "float32", "bfloat16" or "float16"."""
    dev = resolve_device(device)
    model = BASNet(n_channels=3, n_classes=1, dtype=dtype)
    if weights_path and os.path.exists(weights_path):
        model.load_state_dict(torch.load(weights_path, map_location="cpu", weights_only=True),
                              strict=True)
    else:
        init_weights(model, generator or torch.Generator().manual_seed(0))
    return model.to(dev).eval()


def norm_pred(d: torch.Tensor) -> torch.Tensor:
    """Min-max normalisation of each map over its last two axes (the
    reference's ``RunInference.py:36-40``)."""
    lo = torch.amin(d, dim=(-2, -1), keepdim=True)
    hi = torch.amax(d, dim=(-2, -1), keepdim=True)
    return (d - lo) / (hi - lo + 1e-8)


@torch.no_grad()
def saliency_dout(model: torch.nn.Module, images_uint8: torch.Tensor) -> torch.Tensor:
    """[B,H,W,3] uint8 → the raw ``dout`` map [B,256,256] float32 (model in
    eval mode)."""
    x, _ = preprocess_batch(images_uint8, None, size=IMG_SIZE)
    x = normalize_images(x).permute(0, 3, 1, 2)
    return model.eval()(x)[0][:, 0].float()


def saliency_step(model: torch.nn.Module, images_uint8: torch.Tensor) -> torch.Tensor:
    """[B,H,W,3] uint8 → normalised saliency [B,256,256] float in [0,1]."""
    return norm_pred(saliency_dout(model, images_uint8))


def _pil_image():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("writing saliency PNGs needs PIL (Pillow), which is not installed; "
                          "pass output_folder=None to skip them") from e
    return Image


def run_inference(dataset, model: torch.nn.Module | None = None,
                  weights_path: str | None = "./Weights/basnet.pth", num_images: int = 10,
                  batch_size: int = 8, output_folder: str | None = "./basnet_outputs",
                  log=print, device=None, dtype: str = "float32"):
    """Batched ``RunInference.py``: saliency maps, and per-image and mean IoU
    and accuracy against trimap == 1. ``model`` (on its own device) or, when
    None, ``build_basnet(weights_path, device, dtype=dtype)``. PNGs go to ``output_folder``
    unless it is None; they need PIL, which is checked before the model runs.
    A batch holds at most ``num_images`` images. Returns (results list of
    (iou, acc), mean IoU, mean accuracy)."""
    Image = _pil_image() if output_folder else None
    if model is None:
        model = build_basnet(weights_path=weights_path, device=device, dtype=dtype)
    dev = next(model.parameters()).device
    if output_folder:
        os.makedirs(output_folder, exist_ok=True)

    results = []
    processed = 0
    for batch in batches(dataset, min(batch_size, num_images), pad_to_full=True):
        if processed >= num_images:
            break
        preds = saliency_step(model, torch.from_numpy(batch.image).to(dev)).cpu()
        for i in range(batch.num_valid):
            if processed >= num_images:
                break
            orig_h, orig_w = batch.trimap[i].shape
            pred = preds[i]
            # the map resized back to the image's size (the reference's :77)
            pred_resized = resize_bilinear(pred, (orig_h, orig_w)).numpy()
            pred = pred.numpy()
            if Image is not None:
                Image.fromarray((pred * 255).astype(np.uint8)).resize(
                    (orig_w, orig_h)
                ).save(os.path.join(output_folder, f"{processed}_saliency.png"))

            pred_bin = (pred_resized > 0.5).astype(np.uint8)
            gt_bin = (batch.trimap[i] == 1).astype(np.uint8)
            inter = np.logical_and(pred_bin, gt_bin).sum()
            union = np.logical_or(pred_bin, gt_bin).sum()
            iou = inter / union if union > 0 else 1.0
            acc = (pred_bin == gt_bin).mean()
            log(f"{processed} - IoU: {iou:.4f}, Pixel Accuracy: {acc:.4f}")
            results.append((float(iou), float(acc)))
            processed += 1

    mean_iou = sum(i for i, _ in results) / len(results)
    mean_acc = sum(a for _, a in results) / len(results)
    log(f"Mean IoU: {mean_iou:.4f}, Mean Pixel Accuracy: {mean_acc:.4f}")
    return results, mean_iou, mean_acc
