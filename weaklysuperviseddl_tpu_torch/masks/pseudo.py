"""Pseudo-mask generation: CAM → threshold → largest component → store (port of
weaklysuperviseddl_tpu/masks/pseudo.py; ref TraditionalModel/PsuedoMasks.py:23-79).

Two stages, as in the JAX package: ``extract_cams`` drains the loader once,
uploads once and runs LayerCAM batch by batch on the device;
``masks_from_cams`` derives the masks batch by batch and fills a
``MaskStore``: threshold → largest component (on a CUDA tensor through the
connected-components kernel, ``ops/cc.py``), or with ``use_crf=True`` the
reference's script-path variant (AlternatingDirectionCutLoss.py:530-558):
zero the CAM below the threshold, refine it with the dense CRF
(``masks/densecrf.py``, its bilateral filter the CUDA kernel of
``ops/bilateral.py`` on the card), then keep the largest component. Padded
batches repeat the last index, as the JAX index tables do, and their extra
rows are dropped.

In a bfloat16 classifier the stored images stay uint8 and the CAMs float32
(``cam/layercam.py``), so the masks are derived as in float32.

Not ported yet: the host-spilling extraction (``spill_to_host=True``), which
raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from weaklysuperviseddl_tpu_torch.cam.layercam import layercam
from weaklysuperviseddl_tpu_torch.data.mask_store import MaskStore
from weaklysuperviseddl_tpu_torch.data.preprocess import preprocess_batch
from weaklysuperviseddl_tpu_torch.masks.components import keep_largest_batch
from weaklysuperviseddl_tpu_torch.masks.densecrf import apply_dense_crf


def cam_to_mask(cam: torch.Tensor, cam_thresh: float, keep_largest_masks: bool = True):
    """[B,H,W] CAM in [0,1] → uint8 {0,1} masks: zero below the threshold,
    binarise (> 0), optionally keep only the largest connected component
    (ref PsuedoMasks.py:58-65)."""
    cam = torch.where(cam < cam_thresh, torch.zeros_like(cam), cam)
    mask = (cam > 0.0).to(torch.uint8)
    if keep_largest_masks:
        mask = keep_largest_batch(mask)
    return mask


def _store_image_u8(x: torch.Tensor) -> torch.Tensor:
    """Per-image min-max unnormalise [B,H,W,3] float → uint8, on the device
    (the MaskStore's host rule, ref PsuedoMasks.py:72-74)."""
    lo = x.amin(dim=(1, 2, 3), keepdim=True)
    hi = x.amax(dim=(1, 2, 3), keepdim=True)
    return ((x - lo) / (hi - lo).clamp(min=1e-8) * 255).to(torch.uint8)


def _index_table(n: int, batch_size: int) -> np.ndarray:
    """Padded [T,B] index table over n items (padded rows repeat the last index)."""
    T = (n + batch_size - 1) // batch_size
    idx = np.concatenate([np.arange(n), np.repeat(n - 1, T * batch_size - n)])
    return idx.reshape(T, batch_size).astype(np.int64)


@dataclass
class ResidentCams:
    """CAM extraction output, on the device: everything mask derivation needs."""

    images_raw: torch.Tensor    # [N,H,W,3] uint8, the loader's raw decodes
    cams: torch.Tensor          # [N,S,S] float32 in [0,1]
    store_images: torch.Tensor  # [N,S,S,3] uint8 (min-max unnormalised)
    image_size: int
    batch_size: int

    def __len__(self):
        return int(self.cams.shape[0])


def extract_cams(loader, model, alpha: float = 1.0, target_layers=("layer3", "layer4"),
                 alpha_mode: str = "per_layer", image_size: int = 224,
                 max_images: int | None = 500, spill_to_host: bool = False) -> ResidentCams:
    """Stage 1: LayerCAM over the loader's images (capped at ``max_images``),
    with the ground-truth labels selecting the class. Images are preprocessed
    without ImageNet normalisation, as the JAX call site does."""
    if spill_to_host:
        raise NotImplementedError("spill_to_host is not ported yet")
    dev = next(model.parameters()).device
    imgs, labels = [], []
    n, batch_size = 0, None
    cap = np.inf if max_images is None else max_images
    for batch in loader:
        if n >= cap:
            break
        batch_size = batch.image.shape[0] if batch_size is None else batch_size
        take = int(min(batch.num_valid, cap - n))
        imgs.append(np.asarray(batch.image[:take], np.uint8))
        labels.append(np.asarray(batch.label[:take], np.int32))
        n += take
    if n == 0:
        empty = torch.zeros((0, image_size, image_size), device=dev)
        return ResidentCams(torch.zeros((0, image_size, image_size, 3), dtype=torch.uint8,
                                        device=dev), empty,
                            torch.zeros((0, image_size, image_size, 3), dtype=torch.uint8,
                                        device=dev), image_size, batch_size or 1)
    images_all = torch.from_numpy(np.concatenate(imgs)).to(dev)
    labels_all = torch.from_numpy(np.concatenate(labels)).to(dev)
    cams, store_imgs = [], []
    for idx in torch.from_numpy(_index_table(n, batch_size)).to(dev):
        x, _ = preprocess_batch(images_all[idx], None, size=image_size)
        cam, _ = layercam(model, x, labels_all[idx], target_layers=tuple(target_layers),
                          alpha=alpha, alpha_mode=alpha_mode, output_size=image_size)
        cams.append(cam)
        store_imgs.append(_store_image_u8(x))
    return ResidentCams(images_all, torch.cat(cams)[:n], torch.cat(store_imgs)[:n],
                        image_size, batch_size)


def _derive_batch(raw: torch.Tensor, cam: torch.Tensor, cam_thresh: float,
                  keep_largest: bool, use_crf: bool, image_size: int,
                  crf_kwargs: dict) -> torch.Tensor:
    """One batch's masks, uint8 [B,S,S]: ``cam_to_mask``, or with the CRF the
    raw images preprocessed at ``image_size`` (no ImageNet normalisation, as
    in the JAX package), the CAM zeroed below the threshold, the dense CRF on
    [0,255] colours, then optionally the largest component."""
    if not use_crf:
        return cam_to_mask(cam, cam_thresh, keep_largest)
    x, _ = preprocess_batch(raw, None, size=image_size)
    cam_t = torch.where(cam < cam_thresh, torch.zeros_like(cam), cam)
    m = apply_dense_crf(x * 255.0, cam_t, **crf_kwargs)
    if keep_largest:
        m = keep_largest_batch(m)
    return m.to(torch.uint8)


def masks_from_cams(resident: ResidentCams, cam_thresh: float = 0.3,
                    keep_largest_masks: bool = True, use_crf: bool = False,
                    crf_kwargs: dict | None = None, store_dir: str | None = None,
                    order: np.ndarray | None = None,
                    max_images: int | None = None) -> MaskStore:
    """Stage 2: threshold → (optional dense CRF, ``crf_kwargs`` passed to
    ``densecrf_inference``) → largest component, batch by batch; results land
    in a MaskStore keyed by zero-padded running id.

    ``order`` ([M] indices): derive the masks, and take the store images, in
    this order (the ablation grid's shuffled loader order per repeat), as if
    the CAMs had been extracted from a loader in that order. ``max_images``
    caps the output after ordering (the reference caps its shuffled stream,
    PsuedoMasks.py:34)."""
    store = MaskStore(directory=store_dir)
    n_all = len(resident)
    order = np.arange(n_all) if order is None else np.asarray(order, np.int64)
    if max_images is not None:
        order = order[:max_images]
    n = order.shape[0]
    if n == 0:
        return store
    dev = resident.cams.device
    idx_table = torch.from_numpy(order[_index_table(n, resident.batch_size)]).to(dev)
    crf_kwargs = dict(crf_kwargs or {})
    masks = torch.cat([_derive_batch(resident.images_raw[idx] if use_crf else None,
                                     resident.cams[idx], cam_thresh, keep_largest_masks,
                                     use_crf, resident.image_size, crf_kwargs)
                       for idx in idx_table])[:n]
    masks_np = masks.cpu().numpy()
    images_np = resident.store_images[torch.from_numpy(order).to(dev)].cpu().numpy()
    for img_id in range(n):
        store.put(f"{img_id:05d}", images_np[img_id], masks_np[img_id])
    return store


def generate_pseudo_masks(loader, model, cam_thresh: float = 0.3, alpha: float = 1.0,
                          keep_largest_masks: bool = True, run_id: str = "default",
                          target_layers=("layer3", "layer4"), alpha_mode: str = "per_layer",
                          image_size: int = 224, max_images: int = 500,
                          store_dir: str | None = None, use_crf: bool = False,
                          crf_kwargs: dict | None = None,
                          spill_to_host: bool = False) -> MaskStore:
    """``extract_cams`` then ``masks_from_cams``, with the reference contract
    (PsuedoMasks.py:23-79): ground-truth labels drive the CAM class, output
    capped at ``max_images``, masks and min-max-unnormalised images in a
    (optionally PNG-backed) MaskStore keyed by zero-padded running id."""
    del run_id  # kept for the reference's signature
    resident = extract_cams(loader, model, alpha=alpha, target_layers=target_layers,
                            alpha_mode=alpha_mode, image_size=image_size,
                            max_images=max_images, spill_to_host=spill_to_host)
    return masks_from_cams(resident, cam_thresh=cam_thresh,
                           keep_largest_masks=keep_largest_masks, use_crf=use_crf,
                           crf_kwargs=crf_kwargs, store_dir=store_dir)
