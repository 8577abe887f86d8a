"""Synthetic binary masks that the connected-components kernel is held to.

Families: ``blobs`` (thresholded smoothed noise, the shape of real CAM and
segmentation masks), ``speckle`` (50 % random pixels: many components with
long, winding borders), ``snake_spiral`` (one serpentine and one square spiral,
the worst cases for a fixed point of scans), ``full_empty`` (all foreground,
all background). Everything is made with numpy from a seed.
"""

from __future__ import annotations

import numpy as np

FAMILIES = ("blobs", "speckle", "snake_spiral", "full_empty")


def blobs(rng: np.random.Generator, shape, sigma: float = 2.5, keep: float = 0.4) -> np.ndarray:
    """The top ``keep`` fraction of Gaussian-smoothed noise."""
    from scipy import ndimage

    f = ndimage.gaussian_filter(rng.standard_normal(shape), sigma)
    return (f > np.quantile(f, 1 - keep)).astype(np.uint8)


def snake(shape) -> np.ndarray:
    """Serpentine: every other row, joined alternately at the right and left ends."""
    H, W = shape
    m = np.zeros(shape, np.uint8)
    for r in range(0, H, 2):
        m[r] = 1
        if r + 1 < H:
            m[r + 1, W - 1 if (r // 2) % 2 == 0 else 0] = 1
    return m


def spiral(shape) -> np.ndarray:
    """A square spiral walking inwards, one-pixel gaps between its arms: a
    turtle that turns right whenever the next step would touch the path."""
    H, W = shape
    m = np.zeros(shape, np.uint8)
    r = c = d = turns = 0
    m[0, 0] = 1
    steps = ((0, 1), (1, 0), (0, -1), (-1, 0))
    while turns < 2:
        dr, dc = steps[d]
        r1, c1, r2, c2 = r + dr, c + dc, r + 2 * dr, c + 2 * dc
        ahead = 0 <= r2 < H and 0 <= c2 < W and m[r2, c2]
        if 0 <= r1 < H and 0 <= c1 < W and not m[r1, c1] and not ahead:
            r, c, turns = r1, c1, 0
            m[r, c] = 1
        else:
            d, turns = (d + 1) % 4, turns + 1
    return m


def family(name: str, batch: int, shape, seed: int = 0) -> np.ndarray:
    """[batch,H,W] uint8 masks of one family."""
    rng = np.random.default_rng(seed)
    if name == "blobs":
        return np.stack([blobs(rng, shape) for _ in range(batch)])
    if name == "speckle":
        return (rng.random((batch, *shape)) < 0.5).astype(np.uint8)
    if name == "snake_spiral":
        pair = (snake(shape), spiral(shape))
        return np.stack([pair[i % 2] for i in range(batch)])
    if name == "full_empty":
        pair = (np.ones(shape, np.uint8), np.zeros(shape, np.uint8))
        return np.stack([pair[i % 2] for i in range(batch)])
    raise ValueError(f"unknown mask family {name!r}")
