"""Oxford-IIIT Pet ingestion with the reference's contract (port of
weaklysuperviseddl_tpu/data/dataset.py).

``download_data(pth, split)`` returns raw decoded samples ``(image, (category,
trimap))``; ``load_split_data`` is the 80/20 random split of trainval with the
JAX package's permutation, so both packages see the same split. Resizing and
normalisation happen later, batched, on the device (``data/preprocess.py``).
Without Pet data on disk a seeded synthetic dataset with the same contract is
used.

Pet disk layout expected under ``root``: ``images/*.jpg``,
``annotations/trimaps/*.png``, ``annotations/{trainval,test}.txt``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from weaklysuperviseddl_tpu_torch.data.synthetic import synthetic_pet_arrays


@dataclass
class PetDataset:
    """In-memory dataset of decoded, not yet resized samples: ``images`` a list
    of HWC uint8 arrays (possibly ragged), ``labels`` [N] int32 in [0, 37),
    ``trimaps`` a list of HW uint8 arrays in {1,2,3}."""

    images: list
    labels: np.ndarray
    trimaps: list
    split: str

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        return self.images[idx], (int(self.labels[idx]), self.trimaps[idx])


def _pet_root_valid(root: str | None) -> bool:
    if root is None:
        return False
    return os.path.isdir(os.path.join(root, "images")) and os.path.isdir(
        os.path.join(root, "annotations", "trimaps"))


def _load_pet_from_disk(root: str, split: str, limit: int | None = None) -> PetDataset:
    """The first ``limit`` entries (all without it) of the split's list file."""
    from PIL import Image

    with open(os.path.join(root, "annotations", f"{split}.txt")) as f:
        entries = [line.strip().split(" ") for line in f
                   if line.strip() and not line.startswith("#")]
    if limit is not None:
        entries = entries[:limit]
    images, labels, trimaps = [], [], []
    for entry in entries:
        name = entry[0]
        img = Image.open(os.path.join(root, "images", f"{name}.jpg")).convert("RGB")
        tri = Image.open(os.path.join(root, "annotations", "trimaps", f"{name}.png"))
        images.append(np.asarray(img, np.uint8))
        labels.append(int(entry[1]) - 1)  # Pet list files are 1-indexed
        trimaps.append(np.asarray(tri, np.uint8))
    return PetDataset(images, np.asarray(labels, np.int32), trimaps, split)


def _synthetic_dataset(split: str, n: int, image_size: int, seed: int,
                       num_classes: int) -> PetDataset:
    split_seed = seed + {"trainval": 0, "test": 10_000}.get(split, 20_000)
    images, labels, trimaps = synthetic_pet_arrays(
        n, image_size=image_size, seed=split_seed, num_classes=num_classes)
    return PetDataset([(images[i] * 255).astype(np.uint8) for i in range(n)], labels,
                      [trimaps[i] for i in range(n)], split)


def download_data(pth: str | None = None, split: str = "trainval", synthetic_size: int = 128,
                  image_size: int = 224, seed: int = 0, limit: int | None = None,
                  num_classes: int = 37) -> PetDataset:
    """The Pet dataset from disk (its first ``limit`` entries), or a
    synthetic one with the same contract (``min(limit, synthetic_size)``
    pets)."""
    if _pet_root_valid(pth):
        return _load_pet_from_disk(pth, split, limit=limit)
    n = synthetic_size if limit is None else min(limit, synthetic_size)
    return _synthetic_dataset(split, n, image_size, seed, num_classes)


def load_split_data(pth: str | None = None, train_ratio: float = 0.8, seed: int = 0, **kwargs):
    """80/20 random split of trainval (ref ExtraUtilities.py:43-63)."""
    if not 0 < train_ratio < 1:
        raise ValueError("train_ratio must be between 0 and 1 (exclusive)")
    full = download_data(pth=pth, split="trainval", seed=seed, **kwargs)
    total = len(full)
    perm = np.random.default_rng(seed).permutation(total)
    train_size = int(train_ratio * total)

    def subset(idx):
        return PetDataset([full.images[i] for i in idx], full.labels[idx],
                          [full.trimaps[i] for i in idx], full.split)

    return subset(perm[:train_size]), subset(perm[train_size:])
