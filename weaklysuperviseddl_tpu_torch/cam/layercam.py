"""LayerCAM, batched (port of weaklysuperviseddl_tpu/cam/layercam.py;
ref TraditionalModel/LayerCAM.py:7-81 and AlternatingDirectionCutLoss.py:216-318).

The gradients are ``torch.autograd.grad`` of the selected-class logits with
respect to the target stages' outputs: the counterpart of the JAX package's
vjp over zero perturbations added to those outputs.

Per layer: ``relu(grad ⊙ act).sum(channels)`` → relu → per-image min-max
(``fusion="pallas"``: through ``ops/cam_fusion.py``, the CUDA kernel on a CUDA
tensor; ``"auto"`` and ``"xla"``: the plain expression, as JAX's ``"auto"``
resolves to XLA), then either
  * alpha_mode='per_layer': ``**alpha`` → min-max again, or
  * alpha_mode='final': nothing per layer; after the mean over layers,
    ``clamp(0) ** alpha``;
each layer's CAM is upsampled bilinearly (align_corners=False) to
``output_size`` before the mean over layers.

In the classifier's compute dtype: the logits and the target activations
are in it, and so are the gradients (the selected-class one-hot in the
logits' dtype). The fusion widens them to float32 and everything after it
runs in float32, so the CAM is float32 in either dtype. (JAX's target
activations and gradients are float32 even in a bfloat16 model: its float32
zero perturbations promote the stage outputs, whose values stay those of
bfloat16; its fusion, XLA's or the Pallas kernel's, runs in float32.)
"""

from __future__ import annotations

import torch

from weaklysuperviseddl_tpu_torch.ops.cam_fusion import cam_fusion, cam_fusion_plain
from weaklysuperviseddl_tpu_torch.ops.cam_fusion import minmax as _minmax
from weaklysuperviseddl_tpu_torch.ops.resize import resize_bilinear


def layercam(model, images: torch.Tensor, class_idx: torch.Tensor | None,
             target_layers=("layer3", "layer4"), alpha: float = 1.0,
             alpha_mode: str = "per_layer", output_size: int = 224, fusion: str = "auto"):
    """``model``: a ``CamClassifier``. images [B,H,W,3]; class_idx [B] or None
    (→ argmax of the logits). Returns (cam [B,S,S] float32 in [0,1], logits
    [B,K] in the model's compute dtype), both without gradient."""
    if fusion not in ("auto", "xla", "pallas"):
        raise ValueError(f"unknown fusion {fusion!r}")
    if alpha_mode not in ("per_layer", "final"):
        raise ValueError(f"unknown alpha_mode {alpha_mode!r}")
    # the input is a leaf that asks for a gradient, so the activations carry a
    # graph whatever the parameters' requires_grad flags are
    x = images.permute(0, 3, 1, 2).detach().requires_grad_(True)
    with torch.enable_grad():
        logits, feats = model.features(x)
        acts = [feats[name] for name in target_layers]
        if class_idx is None:
            class_idx = logits.argmax(dim=1)
        score = logits.gather(1, class_idx.long().view(-1, 1)).sum()
        grads = torch.autograd.grad(score, acts)

    with torch.no_grad():
        layer_cams = []
        for act, grad in zip(acts, grads):
            fuse = cam_fusion if fusion == "pallas" else cam_fusion_plain
            cam = fuse(act, grad)                            # [B,h,w]
            if alpha_mode == "per_layer":
                cam = _minmax(cam ** alpha)
            layer_cams.append(resize_bilinear(cam, (output_size, output_size), axes=(1, 2)))
        final = sum(layer_cams) / len(layer_cams)
        if alpha_mode == "final":
            final = final.clamp(min=0.0) ** alpha
    return final.float(), logits.detach()
