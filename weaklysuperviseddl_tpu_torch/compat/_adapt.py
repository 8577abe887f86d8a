"""Array and layout adapters shared by the compat modules (port of
weaklysuperviseddl_tpu/compat/_adapt.py, whose shape rules these copy: a
different guess would silently transpose a user's image)."""

from __future__ import annotations

import numpy as np
import torch

from weaklysuperviseddl_tpu_torch.device import resolve_device

# JAX, without 64-bit mode, holds these in 32 bits; the port's models are float32
_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32}


def to_array(x, device=None) -> torch.Tensor:
    """numpy / torch / array-like → a torch tensor (on ``device`` when given),
    float64 and int64 narrowed to 32 bits as JAX narrows them. A tensor keeps
    its autograd graph."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
    t = t.to(_NARROW.get(t.dtype, t.dtype))
    return t if device is None else t.to(device)


def to_numpy(x) -> np.ndarray:
    """``to_array`` on the host, as numpy."""
    return to_array(x).detach().cpu().numpy()


def to_nhwc(x, device=None):
    """[B,3,H,W], [3,H,W], [B,H,W,3] or [H,W,3] → ([B,H,W,3], was_batched)."""
    x = to_array(x, device)
    batched = x.ndim != 3
    if not batched:
        x = x[None]
    if x.shape[1] == 3 and x.shape[-1] != 3:
        x = x.permute(0, 2, 3, 1)
    return x, batched


def to_hw_batch(x, device=None):
    """Masks: [H,W], [B,H,W] or [B,1,H,W] → ([B,H,W], was_batched)."""
    x = to_array(x, device)
    if x.ndim == 2:
        return x[None], False
    if x.ndim == 4:  # [B,1,H,W]
        return x[:, 0], True
    # [1,H,W] with H > 4 is one image with its channel squeezed; any other
    # 3-D input is a batch: both come back as they are
    return x, True


def float_images(x, device) -> torch.Tensor:
    """Images for a model: ``to_nhwc`` on ``device``, integer pixels widened
    to float32 (flax's convolutions promote them; torch's do not)."""
    x, _ = to_nhwc(x, device)
    return x if x.is_floating_point() else x.float()


def data_device(*xs) -> torch.device:
    """The device of the first torch tensor among ``xs``; else the card
    (``resolve_device(None)``, which raises without one)."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return resolve_device(None)


def model_device(model) -> torch.device:
    return next(model.parameters()).device
