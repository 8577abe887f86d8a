"""Pseudo-mask artifact store (port of weaklysuperviseddl_tpu/data/mask_store.py).

The reference's pipeline state is a PNG directory of pseudo-masks; this store
keeps that contract (8-bit PNG masks {0, 255}, reloaded as ``mask == 255``;
keys sorted for alignment) and an in-memory path, which is what the training
loop uses. PNGs are written with PIL, synchronously, imported only when a
directory is given. The JAX package's native asynchronous PNG writer (and so
its ``flush`` barrier) is not ported.

``save_arrays``/``load_arrays`` keep the whole store (keys, images, masks) in
one ``.npz`` file and need no PIL: the checkpoint snapshots use them.
"""

from __future__ import annotations

import os

import numpy as np


class MaskStore:
    """Holds (image uint8 [H,W,3], mask uint8 {0,1} [H,W]) pairs by string key."""

    def __init__(self, directory: str | None = None):
        self.directory = directory
        self._images: dict[str, np.ndarray] = {}
        self._masks: dict[str, np.ndarray] = {}
        if directory is not None:
            self.image_dir = os.path.join(directory, "images")
            self.mask_dir = os.path.join(directory, "pseudo_masks")
            os.makedirs(self.image_dir, exist_ok=True)
            os.makedirs(self.mask_dir, exist_ok=True)

    def put(self, key: str, image: np.ndarray | None, mask: np.ndarray):
        mask = np.asarray(mask).astype(np.uint8)
        if mask.ndim != 2:
            raise ValueError(f"a mask is [H,W], got shape {mask.shape}")
        self._masks[key] = mask
        if image is not None:
            image = np.asarray(image)
            if image.dtype != np.uint8:
                # the reference min-max unnormalises before saving (PsuedoMasks.py:72-74)
                lo, hi = image.min(), image.max()
                image = ((image - lo) / max(hi - lo, 1e-8) * 255).astype(np.uint8)
            self._images[key] = image
        if self.directory is not None:
            from PIL import Image

            Image.fromarray(mask * 255).save(os.path.join(self.mask_dir, f"{key}.png"))
            if image is not None:
                Image.fromarray(image).save(os.path.join(self.image_dir, f"{key}.png"))

    def update_mask(self, key: str, mask: np.ndarray):
        """Refinement overwrite (ref AlternatingDirectionCutLoss.py:808-809)."""
        self.put(key, None, mask)

    def keys(self):
        return sorted(self._masks.keys())

    def __len__(self):
        return len(self._masks)

    def get(self, key: str):
        return self._images.get(key), self._masks[key]

    def as_arrays(self):
        """Stacked (images [N,H,W,3] uint8, masks [N,H,W] uint8 {0,1}, keys),
        sorted by key."""
        ks = self.keys()
        return (np.stack([self._images[k] for k in ks]),
                np.stack([self._masks[k] for k in ks]), ks)

    def save_arrays(self, path: str):
        """Write keys, images and masks to one ``.npz`` file at ``path``,
        synced to disk before it returns."""
        images, masks, keys = self.as_arrays()
        with open(path, "wb") as f:
            np.savez(f, keys=np.asarray(keys, dtype=str), images=images, masks=masks)
            f.flush()
            os.fsync(f.fileno())

    @classmethod
    def load_arrays(cls, path: str) -> "MaskStore":
        """Read back a store written by ``save_arrays`` (in memory)."""
        store = cls(directory=None)
        with np.load(path, allow_pickle=False) as z:
            for key, image, mask in zip(z["keys"].tolist(), z["images"], z["masks"]):
                store._images[key] = image
                store._masks[key] = mask
        return store

    @classmethod
    def load(cls, directory: str) -> "MaskStore":
        """Rehydrate from the PNG directories (mask pixel 255 → foreground)."""
        from PIL import Image

        store = cls(directory=None)
        image_dir = os.path.join(directory, "images")
        mask_dir = os.path.join(directory, "pseudo_masks")
        for fname in sorted(os.listdir(mask_dir)):
            key = os.path.splitext(fname)[0]
            mask = np.asarray(Image.open(os.path.join(mask_dir, fname)).convert("L"))
            store._masks[key] = (mask == 255).astype(np.uint8)
            ipath = os.path.join(image_dir, fname)
            if os.path.exists(ipath):
                store._images[key] = np.asarray(Image.open(ipath).convert("RGB"))
        return store
