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

``spill_to_host=True`` is the streaming form for sets beyond the card's
memory, as in the JAX package: windows of ``batches_per_dispatch`` batches
(8 by default) are uploaded, swept and read back to host numpy before the
next upload, and ``masks_from_cams`` streams the host-resident CAMs through
the card the same way. Each batch runs the same body on the same values, so
the CAMs and masks are bit-identical to the resident path's wherever the
device's kernels are deterministic: always on the CPU, and on the card with
``torch.backends.cudnn.deterministic`` (cuDNN's default backward-data
kernels give two runs of one batch CAMs a few 1e-7 apart). The resident
path runs batch by batch whatever ``batches_per_dispatch`` says (the port
builds no device program to batch over).

Under a ``torch.profiler`` session each stage's host work is a span
(``utils/profiling.span``): ``pseudo/drain`` (the loader's drain and the
concatenation), ``pseudo/upload`` (``bytes``) and ``pseudo/layercam`` (the
enqueue of LayerCAM, batch by batch) in ``extract_cams``; ``pseudo/derive``
(the enqueue of the masks, with a ``crf`` span a batch),
``pseudo/readback`` (masks and store images to the host, ``bytes``) and
``pseudo/store`` (the puts and the flush, ``items``) in ``masks_from_cams``.
The spilled path has the same spans a window, and ``pseudo/readback`` for
the CAMs it keeps on the host.
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
from weaklysuperviseddl_tpu_torch.utils.profiling import span


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
    """CAM extraction output: everything mask derivation needs. With
    ``on_device`` (the default) the tensors live on ``device``, the card's
    memory; without it (``spill_to_host``) they are host numpy arrays and
    derivation streams windows of them through ``device``."""

    images_raw: torch.Tensor    # [N,H,W,3] uint8, the loader's raw decodes
    cams: torch.Tensor          # [N,S,S] float32 in [0,1]
    store_images: torch.Tensor  # [N,S,S,3] uint8 (min-max unnormalised)
    image_size: int
    batch_size: int
    on_device: bool = True
    device: torch.device | None = None  # None: the tensors' device

    def __post_init__(self):
        if self.device is None:
            self.device = self.cams.device if self.on_device else torch.device("cpu")

    def __len__(self):
        return int(self.cams.shape[0])

    def resident_bytes(self) -> int:
        """The device bytes this extraction holds (0 when spilled):
        N·(H·W·3 + S²·4 + S²·3)."""
        if not self.on_device:
            return 0
        return sum(t.numel() * t.element_size()
                   for t in (self.images_raw, self.cams, self.store_images))


def _cam_batch(model, raw, labels, target_layers, alpha, alpha_mode, image_size):
    """One batch's (CAM [B,S,S], store image [B,S,S,3] uint8): the one body
    of the resident and the spilled sweeps, so that they cannot drift."""
    x, _ = preprocess_batch(raw, None, size=image_size)
    cam, _ = layercam(model, x, labels, target_layers=tuple(target_layers), alpha=alpha,
                      alpha_mode=alpha_mode, output_size=image_size)
    return cam, _store_image_u8(x)


def extract_cams(loader, model, alpha: float = 1.0, target_layers=("layer3", "layer4"),
                 alpha_mode: str = "per_layer", image_size: int = 224,
                 max_images: int | None = 500, batches_per_dispatch: int | None = None,
                 spill_to_host: bool = False) -> ResidentCams:
    """Stage 1: LayerCAM over the loader's images (capped at ``max_images``),
    with the ground-truth labels selecting the class. Images are preprocessed
    without ImageNet normalisation, as the JAX call site does. The loader is
    drained once; the set is uploaded once, or with ``spill_to_host`` a
    window of ``batches_per_dispatch`` (default 8) batches at a time, each
    window's results read back to the host before the next upload."""
    dev = next(model.parameters()).device
    imgs, labels = [], []
    n, batch_size = 0, None
    cap = np.inf if max_images is None else max_images
    with span("pseudo/drain"):
        for batch in loader:
            if n >= cap:
                break
            batch_size = batch.image.shape[0] if batch_size is None else batch_size
            take = int(min(batch.num_valid, cap - n))
            imgs.append(np.asarray(batch.image[:take], np.uint8))
            labels.append(np.asarray(batch.label[:take], np.int32))
            n += take
        if n:
            images_np = np.concatenate(imgs)
            labels_np = np.concatenate(labels)
    if n == 0:
        empty = torch.zeros((0, image_size, image_size), device=dev)
        return ResidentCams(torch.zeros((0, image_size, image_size, 3), dtype=torch.uint8,
                                        device=dev), empty,
                            torch.zeros((0, image_size, image_size, 3), dtype=torch.uint8,
                                        device=dev), image_size, batch_size or 1)
    B = batch_size
    idx_table = _index_table(n, B)
    body = dict(target_layers=target_layers, alpha=alpha, alpha_mode=alpha_mode,
                image_size=image_size)

    if spill_to_host:
        K = batches_per_dispatch or 8
        T = idx_table.shape[0]
        cams_np = np.empty((T * B, image_size, image_size), np.float32)
        store_np = np.empty((T * B, image_size, image_size, 3), np.uint8)
        for start in range(0, T, K):
            window = idx_table[start:start + K].reshape(-1)
            with span("pseudo/upload",
                      bytes=window.shape[0] * (images_np[0].nbytes + labels_np[0].nbytes)):
                raws = torch.from_numpy(images_np[window]).to(dev)
                labs = torch.from_numpy(labels_np[window]).to(dev)
            with span("pseudo/layercam"):
                out = [_cam_batch(model, raws[j:j + B], labs[j:j + B], **body)
                       for j in range(0, window.shape[0], B)]
            # the window's readback before the next upload: the device holds
            # one window at a time
            rows = slice(start * B, start * B + window.shape[0])
            with span("pseudo/readback", bytes=cams_np[rows].nbytes + store_np[rows].nbytes):
                cams_np[rows] = torch.cat([c for c, _ in out]).cpu().numpy()
                store_np[rows] = torch.cat([im for _, im in out]).cpu().numpy()
        return ResidentCams(images_np, cams_np[:n], store_np[:n], image_size, B,
                            on_device=False, device=dev)

    with span("pseudo/upload", bytes=images_np.nbytes + labels_np.nbytes):
        images_all = torch.from_numpy(images_np).to(dev)
        labels_all = torch.from_numpy(labels_np).to(dev)
    with span("pseudo/layercam"):
        out = [_cam_batch(model, images_all[idx], labels_all[idx], **body)
               for idx in torch.from_numpy(idx_table).to(dev)]
        cams = torch.cat([c for c, _ in out])[:n]
        store_images = torch.cat([im for _, im in out])[:n]
    return ResidentCams(images_all, cams, store_images, image_size, B)


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
    in a MaskStore keyed by zero-padded running id, flushed before this
    returns (the directory is the stage's output).

    ``order`` ([M] indices): derive the masks, and take the store images, in
    this order (the ablation grid's shuffled loader order per repeat), as if
    the CAMs had been extracted from a loader in that order. ``max_images``
    caps the output after ordering (the reference caps its shuffled stream,
    PsuedoMasks.py:34). Spilled CAMs stream through ``resident.device`` in
    windows of 8 batches."""
    store = MaskStore(directory=store_dir)
    n_all = len(resident)
    order = np.arange(n_all) if order is None else np.asarray(order, np.int64)
    if max_images is not None:
        order = order[:max_images]
    n = order.shape[0]
    if n == 0:
        return store
    B, S = resident.batch_size, resident.image_size
    idx_table = order[_index_table(n, B)]
    crf_kwargs = dict(crf_kwargs or {})

    def derive(raw, cam):
        return _derive_batch(raw, cam, cam_thresh, keep_largest_masks, use_crf, S, crf_kwargs)

    if resident.on_device:
        dev = resident.device
        with span("pseudo/derive"):
            masks = torch.cat([derive(resident.images_raw[idx] if use_crf else None,
                                      resident.cams[idx])
                               for idx in torch.from_numpy(idx_table).to(dev)])[:n]
        with span("pseudo/readback", bytes=n * S * S * 4):
            masks_np = masks.cpu().numpy()
            images_np = resident.store_images[torch.from_numpy(order).to(dev)].cpu().numpy()
    else:
        # upload a window's content, derive, read back: the device holds one
        # window at a time
        K = 8
        masks_np = np.empty((idx_table.size, S, S), np.uint8)
        for start in range(0, idx_table.shape[0], K):
            window = idx_table[start:start + K].reshape(-1)
            raw_bytes = resident.images_raw[0].nbytes if use_crf else 0
            with span("pseudo/upload",
                      bytes=window.shape[0] * (resident.cams[0].nbytes + raw_bytes)):
                cams = torch.from_numpy(resident.cams[window]).to(resident.device)
                raws = (torch.from_numpy(resident.images_raw[window]).to(resident.device)
                        if use_crf else None)
            with span("pseudo/derive"):
                out = [derive(None if raws is None else raws[j:j + B], cams[j:j + B])
                       for j in range(0, window.shape[0], B)]
            with span("pseudo/readback", bytes=window.shape[0] * S * S):
                masks_np[start * B:start * B + window.shape[0]] = torch.cat(out).cpu().numpy()
        masks_np = masks_np[:n]
        images_np = resident.store_images[order]
    with span("pseudo/store", items=n):
        for img_id in range(n):
            store.put(f"{img_id:05d}", images_np[img_id], masks_np[img_id])
        store.flush()
    return store


def generate_pseudo_masks(loader, model, cam_thresh: float = 0.3, alpha: float = 1.0,
                          keep_largest_masks: bool = True, run_id: str = "default",
                          target_layers=("layer3", "layer4"), alpha_mode: str = "per_layer",
                          image_size: int = 224, max_images: int = 500,
                          store_dir: str | None = None, use_crf: bool = False,
                          crf_kwargs: dict | None = None, batches_per_dispatch: int | None = None,
                          spill_to_host: bool = False) -> MaskStore:
    """``extract_cams`` then ``masks_from_cams``, with the reference contract
    (PsuedoMasks.py:23-79): ground-truth labels drive the CAM class, output
    capped at ``max_images``, masks and min-max-unnormalised images in a
    (optionally PNG-backed) MaskStore keyed by zero-padded running id."""
    del run_id  # kept for the reference's signature
    resident = extract_cams(loader, model, alpha=alpha, target_layers=target_layers,
                            alpha_mode=alpha_mode, image_size=image_size,
                            max_images=max_images, batches_per_dispatch=batches_per_dispatch,
                            spill_to_host=spill_to_host)
    return masks_from_cams(resident, cam_thresh=cam_thresh,
                           keep_largest_masks=keep_largest_masks, use_crf=use_crf,
                           crf_kwargs=crf_kwargs, store_dir=store_dir)
