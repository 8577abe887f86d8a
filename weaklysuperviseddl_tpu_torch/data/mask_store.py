"""Pseudo-mask artifact store (port of weaklysuperviseddl_tpu/data/mask_store.py).

The reference's pipeline state is a PNG directory of pseudo-masks; this store
keeps that contract (8-bit PNG masks {0, 255}, reloaded as ``mask == 255``;
keys sorted for alignment) and an in-memory path, which is what the training
loop uses.

With a directory, PNGs are written as in the JAX package: through the port's
native asynchronous writer (``native/``, built with g++ on first use), whose
threads encode and write while the caller goes on, and ``flush`` is the
durability barrier (``masks_from_cams`` calls it at the end of the stage,
``load`` before it lists a directory). Where the writer cannot be built, the
store writes synchronously with PIL, as JAX's does, and says so:
``writer`` is "native" or "pil" (None without a directory) and
``native_error()`` the build's error.

``save_arrays``/``load_arrays`` keep the whole store (keys, images, masks) in
one ``.npz`` file and need no PIL: the checkpoint snapshots use them.
"""

from __future__ import annotations

import os

import numpy as np


def _native_io():
    """The native writer's module, or None where it cannot be built."""
    from weaklysuperviseddl_tpu_torch import native

    try:
        native.load()
    except RuntimeError:
        return None
    return native


def native_error() -> str | None:
    """Why the native writer is unavailable (its build's error), or None."""
    from weaklysuperviseddl_tpu_torch import native

    try:
        native.load()
    except RuntimeError as exc:
        return str(exc)
    return None


class MaskStore:
    """Holds (image uint8 [H,W,3], mask uint8 {0,1} [H,W]) pairs by string key."""

    def __init__(self, directory: str | None = None):
        self.directory = directory
        self._images: dict[str, np.ndarray] = {}
        self._masks: dict[str, np.ndarray] = {}
        self._dirty = False
        self._native = None
        self.writer = None
        if directory is not None:
            self.image_dir = os.path.join(directory, "images")
            self.mask_dir = os.path.join(directory, "pseudo_masks")
            os.makedirs(self.image_dir, exist_ok=True)
            os.makedirs(self.mask_dir, exist_ok=True)
            self._native = _native_io()
            self.writer = "pil" if self._native is None else "native"

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
            self._write_png(key, image, mask)

    def _write_png(self, key: str, image: np.ndarray | None, mask: np.ndarray):
        if self._native is not None:
            self._native.png_write_async(os.path.join(self.mask_dir, f"{key}.png"), mask * 255)
            if image is not None:
                self._native.png_write_async(os.path.join(self.image_dir, f"{key}.png"), image)
            self._dirty = True
            return
        from PIL import Image

        Image.fromarray(mask * 255).save(os.path.join(self.mask_dir, f"{key}.png"))
        if image is not None:
            Image.fromarray(image).save(os.path.join(self.image_dir, f"{key}.png"))

    def flush(self):
        """The durability barrier: returns once every PNG this store queued
        is written; raises ``OSError`` naming the paths that failed."""
        if self._dirty:
            self._dirty = False
            self._native.io_flush()

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
        """Rehydrate from the PNG directories (mask pixel 255 → foreground),
        after the writes still queued have landed."""
        from PIL import Image

        nat = _native_io()
        if nat is not None:
            nat.io_flush()
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
