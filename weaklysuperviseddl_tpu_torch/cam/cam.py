"""Classic CAM: fc weights × the final features, no backward pass (port of
weaklysuperviseddl_tpu/cam/cam.py).

Reference: ``CAMGenerator`` (AlternatingDirectionCutLoss.py:320-403): per
class, CAM = the fc row · layer4's features → ReLU → min-max of each map; the
background map is ``1 − (1 − max over the valid classes' CAMs)^alpha``. One
einsum covers every class, batched over the images.

Images are [B,H,W,3], as ``cam/layercam.py`` takes them. The fc weight is
[K,C] (torch's ``Linear``), where JAX's Dense kernel is [C,K]. In a bfloat16
classifier the features are widened to float32 before the product, as JAX's
einsum promotes them against its float32 kernel.
"""

from __future__ import annotations

import torch

from weaklysuperviseddl_tpu_torch.ops.cam_fusion import minmax
from weaklysuperviseddl_tpu_torch.ops.resize import resize_bilinear


@torch.no_grad()
def class_cams(model, images: torch.Tensor):
    """``model``: a ``CamClassifier``. Returns (CAMs [B,K,h,w] float32, each
    ReLU'd and min-max normalised, logits [B,K]) (ref generate_all_cams,
    AlternatingDirectionCutLoss.py:343-372)."""
    logits, feats = model(images.permute(0, 3, 1, 2))
    cams = torch.einsum("bchw,kc->bkhw", feats[-1].float(), model.fc.weight.float())
    return minmax(torch.relu(cams)), logits


@torch.no_grad()
def cam_bg(model, images: torch.Tensor, valid_class_mask: torch.Tensor, alpha: float = 1.0,
           output_size: int = 224):
    """Background and largest-foreground CAMs (ref generate_bg_cam, :374-403).
    ``valid_class_mask`` [B,K] {0,1}: the classes present in each image (the
    others' CAMs are zeroed, :383-386). Returns (m_bg [B,S,S], max_obj
    [B,S,S]), both resized bilinearly to ``output_size``."""
    cams, _ = class_cams(model, images)
    max_obj = (cams * valid_class_mask[:, :, None, None]).amax(dim=1)
    m_bg = 1.0 - (1.0 - max_obj).clamp(min=0.0) ** alpha
    size = (output_size, output_size)
    return resize_bilinear(m_bg, size, axes=(1, 2)), resize_bilinear(max_obj, size, axes=(1, 2))
