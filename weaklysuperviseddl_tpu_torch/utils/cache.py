"""Bounded LRU memo for captured-program caches (port of
weaklysuperviseddl_tpu/utils/cache.py).

The per-config program memos (``train/segmentation._EPOCH_PROGRAMS``,
``train/alternating._SWEEP_PROGRAMS``) keep alternations and grid repeats
from capturing identical CUDA graphs again. A plain dict grows without bound
in a long-lived sweep or serving process, and every captured graph holds its
own memory pool on the card; this LRU bounds them while keeping the hot
entries. ``discard`` lets an entry go as soon as what it was captured for is
gone (``weakref.finalize`` on the train state's optimizer).
"""

from __future__ import annotations

from collections import OrderedDict


class BoundedCache:
    """Tiny LRU: get/put with eviction of the least-recently-used entry."""

    def __init__(self, maxsize: int = 16):
        if maxsize <= 0:
            raise ValueError(f"maxsize must be positive, got {maxsize}")
        self.maxsize = maxsize
        self._d: OrderedDict = OrderedDict()

    def get(self, key, default=None):
        try:
            self._d.move_to_end(key)
            return self._d[key]
        except KeyError:
            return default

    def put(self, key, value):
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.maxsize:
            self._d.popitem(last=False)

    def discard(self, key):
        """Drop ``key``'s entry, if there is one."""
        self._d.pop(key, None)

    def __len__(self):
        return len(self._d)

    def __contains__(self, key):
        return key in self._d

    def clear(self):
        self._d.clear()
