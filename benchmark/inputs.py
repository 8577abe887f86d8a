"""Inputs the benchmark makes from ``--seed`` and hands to both sides: the
models' random weights and the seeded pet photos, made on the device with a
``torch.Generator`` of the card in a few large calls.

Weights: every convolution and linear weight from N(0, 1/fan_in) (LeCun
normal), drawn as one flat vector and cut into the layers in state-dict
order; biases 0; BatchNorm at the identity (scale 1, shift 0, mean 0,
variance 1).

Pets: the synthetic Oxford-Pet contract of ``data/synthetic.py`` (a flat
background with a little noise, an elliptical pet whose colour follows its
label, a trimap of 1 foreground, 2 background, 3 boundary), drawn on the
device in chunks.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

PET_CLASSES = 37


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) & ((1 << 63) - 1))


@torch.no_grad()
def make_weights(model: nn.Module, seed: int, device) -> dict[str, torch.Tensor]:
    """A state dict for ``model``'s layout (the model may live on the meta
    device), drawn from ``seed`` on ``device``."""
    layers = [(f"{name}.weight", m.weight) for name, m in model.named_modules()
              if isinstance(m, (nn.Conv2d, nn.Linear))]
    flat = torch.randn(sum(w.numel() for _, w in layers), generator=generator(seed, device),
                       device=device)
    out, offset = {}, 0
    for key, w in layers:
        out[key] = flat[offset:offset + w.numel()].view(w.shape).mul_(w[0].numel() ** -0.5)
        offset += w.numel()
    ones = {f"{name}.{leaf}" for name, m in model.named_modules()
            if isinstance(m, nn.BatchNorm2d) for leaf in ("weight", "running_var")}
    for key, t in model.state_dict(keep_vars=True).items():
        if key not in out:
            out[key] = torch.full(t.shape, 1.0 if key in ones else 0.0, dtype=t.dtype,
                                  device=device)
    return out


@torch.no_grad()
def pets(n: int, height: int, width: int, seed: int, device, chunk: int = 128):
    """(uint8 images [n,H,W,3], int64 labels [n], uint8 trimaps [n,H,W]) on
    ``device``, drawn from one generator in a fixed order."""
    images = torch.empty((n, height, width, 3), dtype=torch.uint8, device=device)
    trimaps = torch.empty((n, height, width), dtype=torch.uint8, device=device)
    g = generator(seed, device)
    labels = torch.randint(0, PET_CLASSES, (n,), generator=g, device=device)
    shape = torch.rand((n, 7), generator=g, device=device)
    bg = 0.1 + 0.4 * shape[:, :3]
    cy = (0.3 + 0.4 * shape[:, 3]) * height
    cx = (0.3 + 0.4 * shape[:, 4]) * width
    ry = (0.15 + 0.15 * shape[:, 5]) * height
    rx = (0.15 + 0.15 * shape[:, 6]) * width
    hue = labels.float() / PET_CLASSES
    fg = torch.stack([0.5 + 0.5 * torch.cos(2 * math.pi * (hue + k / 3)) for k in range(3)], 1)
    yy = torch.arange(height, device=device, dtype=torch.float32).view(1, -1, 1)
    xx = torch.arange(width, device=device, dtype=torch.float32).view(1, 1, -1)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        b = e - s
        noise = torch.randn((b, height, width, 3), generator=g, device=device)
        d = (((yy - cy[s:e, None, None]) / ry[s:e, None, None]) ** 2
             + ((xx - cx[s:e, None, None]) / rx[s:e, None, None]) ** 2)
        inside = (d <= 1.0)[..., None]
        img = torch.where(inside, fg[s:e, None, None] + 0.05 * noise,
                          bg[s:e, None, None] + 0.03 * noise)
        images[s:e] = (img.clamp(0.0, 1.0) * 255).to(torch.uint8)
        tri = torch.full((b, height, width), 2, dtype=torch.uint8, device=device)
        tri[(d > 1.0) & (d <= 1.35)] = 3
        tri[d <= 1.0] = 1
        trimaps[s:e] = tri
    return images, labels, trimaps
