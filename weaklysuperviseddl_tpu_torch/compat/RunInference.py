"""Reference surface: PretrainedBasnetModel/RunInference.py (port of
weaklysuperviseddl_tpu/compat/RunInference.py).

The reference is a script (``basnet.pth`` → per-image saliency → IoU and
accuracy against trimap == 1 over the first 10 test images). Here it is a
callable ``main`` over the batched engine (``pipelines/basnet_infer.py``),
with the reference's helpers by name.
"""

from __future__ import annotations

import numpy as np

from weaklysuperviseddl_tpu_torch.compat._adapt import to_array, to_numpy
from weaklysuperviseddl_tpu_torch.pipelines import basnet_infer as _engine
from weaklysuperviseddl_tpu_torch.pipelines.basnet_infer import (  # noqa: F401
    build_basnet,
    run_inference,
)


def norm_pred(d):
    """Reference RunInference.py:36-40: min-max of each map, on its device."""
    return _engine.norm_pred(to_array(d))


def compute_metrics(pred_mask, gt_mask):
    """Reference RunInference.py:42-55: the prediction thresholded at 0.5,
    the truth trimap == 1; (iou, accuracy, pred_bin, gt_bin), numpy."""
    pred_bin = (to_numpy(pred_mask) > 0.5).astype(np.uint8)
    gt_bin = (to_numpy(gt_mask) == 1).astype(np.uint8)
    intersection = np.logical_and(pred_bin, gt_bin).sum()
    union = np.logical_or(pred_bin, gt_bin).sum()
    iou = intersection / union if union > 0 else 1.0
    accuracy = (pred_bin == gt_bin).sum() / pred_bin.size
    return iou, accuracy, pred_bin, gt_bin


def main(model_path: str = "./Weights/basnet.pth",
         dataset_root: str | None = "./OxfordIIITPetDataset/oxford-iiit-pet",
         output_folder: str | None = "./basnet_outputs", num_images: int = 10, log=print,
         device=None):
    """The script's body (RunInference.py:9-126), batched, on ``device``
    (None: the card). Returns ``run_inference``'s (results, mean IoU, mean
    accuracy)."""
    from weaklysuperviseddl_tpu_torch.data.dataset import download_data

    dataset = download_data(dataset_root, split="test", synthetic_size=num_images)
    return run_inference(dataset, weights_path=model_path, num_images=num_images,
                         output_folder=output_folder, log=log, device=device)


if __name__ == "__main__":
    main()
