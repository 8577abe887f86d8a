"""Reference surface: TraditionalModel/LayerCAM.py and the 3-layer variant of
AlternatingDirectionCutLoss.py:216-318 (port of
weaklysuperviseddl_tpu/compat/LayerCAM.py).

``LayerCAMGenerator`` keeps the reference's constructor and ``generate``
signature, hook-free over ``cam/layercam.py``, batched. ``generate`` takes
the CutLoss variant's argument order ``(images, class_idx=None, alpha=1.0)``
and an image or a batch in any layout. CAMs come back as tensors on the
model's device. ``fusion`` stays "auto", as in the JAX package, so the
LayerCAM fusion kernel (K5) is not on this path.
"""

from __future__ import annotations

import torch

from weaklysuperviseddl_tpu_torch.cam.layercam import layercam, layercam_bg
from weaklysuperviseddl_tpu_torch.compat._adapt import float_images, model_device, to_array
from weaklysuperviseddl_tpu_torch.ops.resize import resize_nearest
from weaklysuperviseddl_tpu_torch.utils.metrics import compute_iou_and_acc


class LayerCAMGenerator:
    """``model``: a ``FrozenResNetCAM`` (any ``CamClassifier``); the CAMs
    run on its device."""

    def __init__(self, model, target_layer_names=("layer3", "layer4"),
                 alpha_mode: str = "per_layer", output_size: int = 224):
        self.model = model
        self.target_layer_names = tuple(target_layer_names)
        self.alpha_mode = alpha_mode
        self.output_size = output_size

    def _inputs(self, images, class_idx):
        dev = model_device(self.model)
        x = float_images(images, dev)
        cls = None if class_idx is None else to_array(class_idx, dev).reshape(-1).long()
        return x, cls

    def generate(self, images, class_idx=None, alpha: float = 1.0) -> torch.Tensor:
        """CAM [B,S,S] in [0,1] (a batch dimension always, as the reference's
        LayerCAM.py:81); ``class_idx`` None → each image's argmax class."""
        x, cls = self._inputs(images, class_idx)
        cam, _ = layercam(self.model, x, cls, target_layers=self.target_layer_names,
                          alpha=float(alpha), alpha_mode=self.alpha_mode,
                          output_size=self.output_size)
        return cam

    def generate_bg_cam(self, image_tensor, valid_class_indices, alpha: float = 2.0):
        """Reference :296-318, the first valid class only: (m_bg [S,S],
        the class's CAM [S,S])."""
        x, cls = self._inputs(image_tensor, valid_class_indices)
        m_bg, cam = layercam_bg(self.model, x, cls[:1], target_layers=self.target_layer_names,
                                alpha=float(alpha), output_size=self.output_size)
        return m_bg[0], cam[0]


def evaluate_layercam_on_test_set(layercam_gen, test_loader, alpha: float = 1.0,
                                  cam_thresh: float = 0.3, max_images: int = 10, log=print):
    """Reference LayerCAM.py:84-130: IoU and accuracy of the thresholded CAM's
    foreground against the trimap's (trimap == 1), over the first
    ``max_images`` + 1 images (the reference's off-by-one)."""
    ious_fg, accs_fg = [], []
    done = 0
    for batch in test_loader:
        cams = layercam_gen.generate(batch.image, class_idx=batch.label, alpha=alpha)
        cams = torch.where(cams < cam_thresh, torch.zeros_like(cams), cams)
        pred_fg = (cams > 0.0).to(torch.int32)
        truth = torch.from_numpy(batch.trimap).to(cams.device)
        for i in range(batch.num_valid):
            true_mask = (truth[i] == 1).to(torch.int32)
            pf = pred_fg[i]
            if pf.shape != true_mask.shape:
                pf = resize_nearest(pf, tuple(true_mask.shape), torch_legacy=True)
            iou, acc = compute_iou_and_acc(pf, true_mask)
            ious_fg.append(float(iou))
            accs_fg.append(float(acc))
            done += 1
            if done > max_images:
                break
        if done > max_images:
            break

    log("\n Evaluation of CAMs on test set:")
    log(f" - LayerCam FG: Avg IoU: {sum(ious_fg) / len(ious_fg):.4f} | "
        f"Acc: {sum(accs_fg) / len(accs_fg):.4f}")
    return {"layercam_fg_iou": sum(ious_fg) / len(ious_fg),
            "layercam_fg_acc": sum(accs_fg) / len(accs_fg)}
