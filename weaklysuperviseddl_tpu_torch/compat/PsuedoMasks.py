"""Reference surface: TraditionalModel/PsuedoMasks.py, the file name's typo
kept (port of weaklysuperviseddl_tpu/compat/PsuedoMasks.py).

``generate_pseudo_masks(loader, layercam_gen, cam_thresh, alpha,
keep_largest_masks, run_id)`` keeps the reference's signature and its file
contract, returning ``(image_save_dir, save_dir)`` of PNG directories, and
runs CAM → threshold → largest component batched on the model's device: on
the card the largest component comes from the connected-components kernel
(K2), as does ``keep_largest``'s.
"""

from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np

from weaklysuperviseddl_tpu_torch.compat._adapt import data_device, to_hw_batch
from weaklysuperviseddl_tpu_torch.data.mask_store import MaskStore
from weaklysuperviseddl_tpu_torch.masks.components import keep_largest_batch
from weaklysuperviseddl_tpu_torch.masks.pseudo import cam_to_mask


def delete_dir_recursive(path):
    """Reference PsuedoMasks.py:5-12."""
    if os.path.exists(path):
        shutil.rmtree(path)


def keep_largest(mask) -> np.ndarray:
    """Reference PsuedoMasks.py:15-21 (skimage's labelling → the port's): the
    largest 8-connected component of an [H,W] mask (numpy or torch), as uint8
    numpy, labelled on the mask's device if it is a tensor, else on the card."""
    m, _ = to_hw_batch(mask, data_device(mask))
    return keep_largest_batch(m[:1]).cpu().numpy()[0]


def generate_pseudo_masks(loader, layercam_gen, cam_thresh: float = 0.3, alpha: float = 1.0,
                          keep_largest_masks: bool = True, run_id: str = "default",
                          root: str | None = None, max_images: int = 500, log=print):
    """Reference signature and directory contract (PsuedoMasks.py:23-79):
    ``{root}/pseudo_masks_{run_id}`` and ``{root}/images_{run_id}`` hold one
    PNG per image, named by its running id (root: the temporary directory,
    not the reference's /content), at most ``max_images``. The loader's raw
    images go to the CAM as they are, as in the JAX package."""
    root = root or tempfile.gettempdir()
    save_dir = os.path.join(root, f"pseudo_masks_{run_id}")
    image_save_dir = os.path.join(root, f"images_{run_id}")
    for d in (save_dir, image_save_dir):
        delete_dir_recursive(d)

    store_dir = os.path.join(root, f"_store_{run_id}")
    delete_dir_recursive(store_dir)
    store = MaskStore(directory=store_dir)

    img_id = 0
    for batch in loader:
        if img_id >= max_images:
            break
        cams = layercam_gen.generate(batch.image, class_idx=batch.label, alpha=alpha)
        masks = cam_to_mask(cams, cam_thresh, keep_largest_masks).cpu().numpy()
        x = batch.image.astype(np.float32) / 255.0
        for i in range(batch.num_valid):
            if img_id >= max_images:
                break
            store.put(f"{img_id}", x[i], masks[i])
            img_id += 1

    # the writers hold paths into the store's directories: flush, then rename
    # them into the reference's layout
    store.flush()
    os.rename(store.mask_dir, save_dir)
    os.rename(store.image_dir, image_save_dir)
    delete_dir_recursive(store_dir)
    log(f"Pseudo masks saved to: {save_dir}")
    log(f"Images saved to: {image_save_dir}")
    return image_save_dir, save_dir
