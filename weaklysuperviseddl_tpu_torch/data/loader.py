"""Host-side batcher feeding the device preprocessing (port of
weaklysuperviseddl_tpu/data/loader.py).

Same order, same ``pad_to_full`` padding and the same host resize policy as
the JAX package: uniform datasets (synthetic) stack as they are; ragged decodes
(real Pet) are host-resized with PIL to 256² (the JAX default ``stack_size``).
PIL is imported only on that path. ``prefetch`` stacks batches on a
background thread while the caller works on the last one.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np

STACK_SIZE = 256


@dataclass
class Batch:
    image: np.ndarray   # [B,H,W,3] uint8
    label: np.ndarray   # [B] int32
    trimap: np.ndarray  # [B,H,W] uint8
    # count of real (non-padded) examples; == B except possibly the last batch
    num_valid: int = -1

    def __post_init__(self):
        if self.num_valid < 0:
            self.num_valid = self.image.shape[0]


def _host_resize(img: np.ndarray, size: int, nearest: bool = False) -> np.ndarray:
    from PIL import Image

    method = Image.NEAREST if nearest else Image.BILINEAR
    return np.asarray(Image.fromarray(img).resize((size, size), method), np.uint8)


def _is_uniform(dataset) -> bool:
    """True when every decoded image has one shape (stackable as is)."""
    first = dataset.images[0].shape if len(dataset) else None
    return all(img.shape == first for img in dataset.images)


def _sample_at(dataset, i: int, uniform: bool):
    """(image, trimap) at index i, host-resized only if the dataset is ragged:
    the one resize policy of both ``batches`` and ``stack_dataset``."""
    img, tri = dataset.images[i], dataset.trimaps[i]
    if not uniform:
        img = _host_resize(img, STACK_SIZE)
        tri = _host_resize(tri, STACK_SIZE, nearest=True)
    return img, tri


def batches(dataset, batch_size: int, shuffle: bool = False, seed: int = 0,
            pad_to_full: bool = False) -> Iterator[Batch]:
    """Yield stacked uint8 batches. ``pad_to_full`` repeats the last example
    to keep the batch shape; ``Batch.num_valid`` records the real count."""
    n = len(dataset)
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    uniform = _is_uniform(dataset)
    for start in range(0, n, batch_size):
        idx = order[start:start + batch_size]
        samples = [_sample_at(dataset, i, uniform) for i in idx]
        imgs = [s[0] for s in samples]
        tris = [s[1] for s in samples]
        num_valid = len(idx)
        if pad_to_full and num_valid < batch_size:
            pad = batch_size - num_valid
            imgs += [imgs[-1]] * pad
            tris += [tris[-1]] * pad
            idx = np.concatenate([idx, np.repeat(idx[-1], pad)])
        yield Batch(image=np.stack(imgs).astype(np.uint8),
                    label=dataset.labels[idx].astype(np.int32),
                    trimap=np.stack(tris), num_valid=num_valid)


def stack_dataset(dataset):
    """Drain a PetDataset once into stacked arrays: (images [N,H,W,3] uint8,
    labels [N] int32, trimaps [N,H,W] uint8), resized as ``batches`` does."""
    uniform = _is_uniform(dataset)
    samples = [_sample_at(dataset, i, uniform) for i in range(len(dataset))]
    return (np.stack([s[0] for s in samples]).astype(np.uint8),
            dataset.labels.astype(np.int32),
            np.stack([s[1] for s in samples]).astype(np.uint8))


def prefetch(iterator, size: int = 2):
    """Iterate ``iterator`` on a background thread, at most ``size`` items
    ahead, in order: host decoding and stacking overlap the device's work
    (the reference's DataLoader workers, AlternatingDirectionCutLoss.py:476).

    An exception the iterator raises is raised here, after the items before
    it; JAX's ``prefetch`` ends the stream silently instead. Leaving the loop
    early stops the thread at its next item."""
    q: queue.Queue = queue.Queue(maxsize=size)
    done = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        exc = None
        try:
            for item in iterator:
                if not put((item, None)):
                    return
        except Exception as e:  # handed to the consumer, which raises it
            exc = e
        finally:
            put((done, exc))

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item, exc = q.get()
            if item is done:
                if exc is not None:
                    raise exc
                return
            yield item
    finally:
        stop.set()
        thread.join(timeout=1.0)
