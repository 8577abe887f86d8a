"""Reference surface: TraditionalModel/ExtraUtilities.py (port of
weaklysuperviseddl_tpu/compat/ExtraUtilities.py)."""

from __future__ import annotations

from weaklysuperviseddl_tpu_torch.compat._adapt import to_array
from weaklysuperviseddl_tpu_torch.data.dataset import download_data, load_split_data  # noqa: F401
from weaklysuperviseddl_tpu_torch.utils import metrics as _metrics


def compute_iou_and_acc(pred_mask, true_mask):
    """Reference ExtraUtilities.py:4-21: Python floats, as ``.item()`` gives.
    The truth goes to the prediction's device."""
    pred = to_array(pred_mask)
    iou, acc = _metrics.compute_iou_and_acc(pred, to_array(true_mask, pred.device))
    return float(iou), float(acc)
