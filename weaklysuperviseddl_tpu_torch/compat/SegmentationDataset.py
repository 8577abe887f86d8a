"""Reference surface: TraditionalModel/SegmentationDataset.py (port of
weaklysuperviseddl_tpu/compat/SegmentationDataset.py).

``PseudoSegmentationDataset(img_dir, mask_dir, transform)`` keeps the
reference's contract: two PNG directories aligned by sorted file name; the
joint transform (image to 256² bilinear, [0,1], ImageNet normalisation; mask
to 256² nearest); ``__getitem__ → (image, mask)``, with the CutLoss variant's
file name as a third element under ``return_name=True``
(AlternatingDirectionCutLoss.py:431-466). Items are numpy, HWC float32
images and int64 masks, as in the JAX package; PIL is imported where a file
is read.
"""

from __future__ import annotations

import os

import numpy as np

from weaklysuperviseddl_tpu_torch.data.preprocess import IMAGENET_MEAN, IMAGENET_STD

_MEAN = np.array(IMAGENET_MEAN, np.float32)
_STD = np.array(IMAGENET_STD, np.float32)


def normalize_image(image) -> np.ndarray:
    """An HWC uint8 image (numpy or PIL) → [0,1], ImageNet-normalised float32."""
    return (np.asarray(image, np.float32) / 255.0 - _MEAN) / _STD


class PseudoSegmentationDataset:
    def __init__(self, img_dir, mask_dir, transform=False, return_name=False):
        self.img_dir = img_dir
        self.mask_dir = mask_dir
        self.image_list = sorted(os.listdir(img_dir))
        self.mask_list = sorted(os.listdir(mask_dir))
        self.transform = transform
        self.return_name = return_name

    def __len__(self):
        return len(self.image_list)

    def joint_transform(self, image, mask):
        """Resize to 256², ImageNet normalisation; nearest mask resize (ref :19-28)."""
        from PIL import Image as PILImage

        image = image.resize((256, 256), PILImage.BILINEAR)
        mask = mask.resize((256, 256), PILImage.NEAREST)
        return normalize_image(image), np.asarray(mask).astype(np.int64)

    def __getitem__(self, idx):
        from PIL import Image as PILImage

        img_path = os.path.join(self.img_dir, self.image_list[idx])
        mask_path = os.path.join(self.mask_dir, self.mask_list[idx])
        image = PILImage.open(img_path).convert("RGB")
        mask = PILImage.open(mask_path).convert("L")
        if self.transform:
            image, mask = self.joint_transform(image, mask)
        else:
            image, mask = np.asarray(image), np.asarray(mask)
        if self.return_name:
            return image, mask, os.path.basename(img_path)
        return image, mask
