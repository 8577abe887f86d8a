"""Deterministic synthetic Oxford-Pet-like data (port of
weaklysuperviseddl_tpu/data/synthetic.py).

The same contract and the same seeded numpy RNG calls in the same order, so
both packages produce byte-identical arrays from one seed: an RGB image in
[0,1] with an elliptical "pet" whose colour follows its label, a category in
[0, num_classes), and a trimap in {1: fg, 2: bg, 3: boundary}.
"""

from __future__ import annotations

import numpy as np


def synthetic_pet_arrays(n: int, image_size: int = 224, num_classes: int = 37, seed: int = 0):
    """Returns (images [n,H,W,3] float32 in [0,1], labels [n] int32,
    trimaps [n,H,W] uint8 in {1,2,3})."""
    rng = np.random.default_rng(seed)
    H = W = image_size
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)

    images = np.empty((n, H, W, 3), np.float32)
    labels = rng.integers(0, num_classes, size=n).astype(np.int32)
    trimaps = np.empty((n, H, W), np.uint8)

    for i in range(n):
        label = labels[i]
        # background: a flat colour plus a little noise
        bg = rng.uniform(0.1, 0.5, size=(3,)).astype(np.float32)
        img = np.broadcast_to(bg, (H, W, 3)).copy()
        img += rng.normal(0, 0.03, size=(H, W, 3)).astype(np.float32)

        # foreground ellipse; colour keyed to the class label
        cy = rng.uniform(0.3, 0.7) * H
        cx = rng.uniform(0.3, 0.7) * W
        ry = rng.uniform(0.15, 0.3) * H
        rx = rng.uniform(0.15, 0.3) * W
        d = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2
        fg = d <= 1.0
        boundary = (d > 1.0) & (d <= 1.35)

        hue = label / num_classes
        fg_color = np.array(
            [0.5 + 0.5 * np.cos(2 * np.pi * hue),
             0.5 + 0.5 * np.cos(2 * np.pi * (hue + 1 / 3)),
             0.5 + 0.5 * np.cos(2 * np.pi * (hue + 2 / 3))],
            np.float32,
        )
        img[fg] = fg_color + rng.normal(0, 0.05, size=(int(fg.sum()), 3)).astype(np.float32)
        img = np.clip(img, 0.0, 1.0)

        tri = np.full((H, W), 2, np.uint8)
        tri[boundary] = 3
        tri[fg] = 1

        images[i] = img
        trimaps[i] = tri

    return images, labels, trimaps
