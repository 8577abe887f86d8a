"""The segmentation model's dropout mask as the configuration defines it: a
counter-based hash, so that a key fixes the mask on any device.

Element i (row-major, from 0) of a mask is kept where the top 24 bits of
splitmix64's finaliser applied to ``key + (i + 1)·γ`` (γ = 0x9E3779B97F4A7C15,
arithmetic modulo 2⁶⁴) fall below (1 − p)·2²⁴. A training step's key is
splitmix64 run over (seed + 1, epoch, step): ``h = mix(h ^ v)`` for each,
from h = 0.
"""

from __future__ import annotations

import torch

M64 = (1 << 64) - 1
GAMMA = 0x9E3779B97F4A7C15
MIX1 = 0xBF58476D1CE4E5B9
MIX2 = 0x94D049BB133111EB


def _signed(v: int) -> int:
    v &= M64
    return v - (1 << 64) if v >> 63 else v


def splitmix64(x: int) -> int:
    """splitmix64's step on a Python integer: the increment, then the finaliser."""
    x = (x + GAMMA) & M64
    x = ((x ^ (x >> 30)) * MIX1) & M64
    x = ((x ^ (x >> 27)) * MIX2) & M64
    return x ^ (x >> 31)


def step_key(seed: int, epoch: int, step: int) -> int:
    """The dropout key of one training step of a run seeded ``seed``."""
    h = 0
    for v in (seed + 1, epoch, step):
        h = splitmix64(h ^ (v & M64))
    return h


def _lshr(x: torch.Tensor, s: int) -> torch.Tensor:
    return (x >> s) & ((1 << (64 - s)) - 1)


def keep_mask(key: int, shape, p: float, device) -> torch.Tensor:
    """Boolean keep mask of ``shape`` for ``key`` (a 64-bit pattern)."""
    n = 1
    for d in shape:
        n *= d
    i = torch.arange(1, n + 1, dtype=torch.int64, device=device)
    x = i * _signed(GAMMA) + _signed(key)
    x = (x ^ _lshr(x, 30)) * _signed(MIX1)
    x = (x ^ _lshr(x, 27)) * _signed(MIX2)
    x = x ^ _lshr(x, 31)
    return (_lshr(x, 40) < round((1.0 - p) * (1 << 24))).view(*shape)
