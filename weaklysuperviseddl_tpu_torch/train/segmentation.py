"""Segmentation training (port of weaklysuperviseddl_tpu/train/segmentation.py).

Only the image normalisation that the serving path shares is ported so far;
the training slice fills in the rest of this module.
"""

from weaklysuperviseddl_tpu_torch.data.preprocess import normalize_images as _normalize_images

__all__ = ["_normalize_images"]
