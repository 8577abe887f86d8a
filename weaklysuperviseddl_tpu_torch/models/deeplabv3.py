"""DeepLabV3 (port of weaklysuperviseddl_tpu/models/deeplabv3.py), NCHW.

torchvision's ``deeplabv3_resnet50`` layout and state-dict keys:

  * ResNet backbone at output stride 8 (layer3 and layer4 dilated)
  * ``classifier.0``: ASPP over layer4 — 1x1 conv, three 3x3 atrous convs
    (rates 12/24/36) and an image-pooling branch, each → ``head_ch`` BN ReLU;
    concat → 1x1 project → BN → ReLU → Dropout(0.5)
  * ``classifier.1-3``: 3x3 conv → BN → ReLU; ``classifier.4``: 1x1 conv to
    ``num_classes`` (with bias)
  * bilinear upsample of the logits to the input size (align_corners=False;
    ``ops/resize.upsample_bilinear``, whose backward on the card does not
    add with atomics, so that a training step is deterministic there)

An ASPP branch's 3x3 atrous convolution (``AtrousConv``) runs the JAX
``_AtrousTapConv`` plan: where ``4·rate ≥ min(H, W)`` (every rate at the
served 32² layer4 map) it is one 1x1 product per in-bounds tap over the
output region that tap reaches, summed in a float32 buffer and rounded once
to the compute dtype; below that, the dilated convolution. The taps skip the
products with the zero padding that a dilated convolution of rate 36 on a
32² map spends 8/9 of its work on. The plan also fixes int8 serving, where
each of JAX's taps is a quantized site of its own with its own scales:
``AtrousConv.taps`` gives the taps at an input size (``ops/quant.py`` walks
them).

``dtype`` is the compute dtype (``models/resnet.set_compute_dtype``) of the
backbone, the ASPP (its pooled branch too), the head and the classifier
conv; the logits are cast to float32 before the bilinear resize, so every
loss, softmax and evaluation downstream runs in float32, as in JAX.

The ASPP's dropout (``Dropout``) draws its mask from a counter-based hash of
its key and each element's index, never from torch's global random state; the
key is a 0-dim tensor on the module's device, and the training loop sets it
before each step (``seed_dropout``, from a host integer or from a device
tensor inside a captured CUDA graph), so a run depends on its seed alone, as
in the JAX package (whose keys come from the training call's seed), and the
card and the CPU draw the same mask.
``bn_frozen=True`` is the JAX model's frozen-BN mode: in training every
BatchNorm of the backbone, the ASPP and the head uses its running statistics
and leaves them untouched, while its affines still learn and the dropout
stays active. The default (False) is the reference's semantics.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn as nn

from weaklysuperviseddl_tpu_torch.models.resnet import (
    BatchNorm2d,
    Conv2d,
    ResNetBackbone,
    set_compute_dtype,
)
from weaklysuperviseddl_tpu_torch.ops.resize import upsample_bilinear


_M64 = (1 << 64) - 1


def _int64(v: int) -> int:
    """A 64-bit pattern as the signed value an int64 tensor holds."""
    v &= _M64
    return v - (1 << 64) if v >> 63 else v


_GOLDEN = _int64(0x9E3779B97F4A7C15)   # splitmix64's increment and multipliers
_MIX1 = _int64(0xBF58476D1CE4E5B9)
_MIX2 = _int64(0x94D049BB133111EB)
_UNIT_BITS = 24                      # a draw is the top 24 bits of a hash


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 (torch's ``>>`` is arithmetic)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64's finaliser on int64 tensors (products wrap modulo 2⁶⁴)."""
    x = (x ^ _shr(x, 30)) * _MIX1
    x = (x ^ _shr(x, 27)) * _MIX2
    return x ^ _shr(x, 31)


def keep_mask(key: torch.Tensor, shape, p: float, offset: int = 0) -> torch.Tensor:
    """The dropout's keep mask of ``shape`` for a 0-dim int64 ``key``: element
    i (row-major, counted from ``offset``) is kept where the top 24 bits of
    splitmix64(key + (offset + i + 1)·γ) fall below (1 − p)·2²⁴. A pure
    function of the key and the index, computed on the key's device."""
    n = 1
    for d in shape:
        n *= d
    idx = torch.arange(offset + 1, offset + n + 1, dtype=torch.int64, device=key.device)
    draws = _shr(_mix64(key + idx * _GOLDEN), 64 - _UNIT_BITS)
    return (draws < round((1.0 - p) * (1 << _UNIT_BITS))).view(shape)


class Dropout(nn.Module):
    """``nn.Dropout``'s function (each unit kept with probability 1 − p and
    scaled by 1/(1 − p) in training, the identity otherwise; no state-dict
    entries) with the mask ``keep_mask(self.key, ...)``. ``key`` is a 0-dim
    int64 buffer (not in the state dict) that moves with the module; each
    draw replaces it by a hash of itself, so draws after one seed differ.
    ``manual_seed`` sets it; an unseeded module draws from key 0.

    ``batch_shard`` (set for a training step on a batch split over the
    'data' axis): (D, d), the batch is shard d of D equal shards of a global
    batch; the mask is this shard's rows of the global batch's mask, so a
    seed gives the mask of the one-device step on that batch."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = p
        self.register_buffer("key", torch.zeros((), dtype=torch.int64), persistent=False)
        self.batch_shard: tuple[int, int] | None = None

    @torch.no_grad()
    def manual_seed(self, seed, device: torch.device | None = None):
        """Set the key from a host integer (any 64-bit pattern) or a 0-dim
        integer tensor; ``device`` moves the key there first."""
        if device is not None and self.key.device != torch.device(device):
            self.key = self.key.to(device)
        if isinstance(seed, torch.Tensor):
            self.key.copy_(seed)
        else:
            self.key.fill_(_int64(int(seed)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.key.device != x.device:
            self.key = self.key.to(x.device)
        offset = 0 if self.batch_shard is None else self.batch_shard[1] * x.numel()
        keep = keep_mask(self.key, x.shape, self.p, offset)
        with torch.no_grad():
            self.key.copy_(_mix64(self.key + _GOLDEN))
        return x * keep.to(x.dtype).div_(1.0 - self.p)


def seed_dropout(model: nn.Module, seed):
    """Seed every ``Dropout`` of ``model`` on the device of its parameters,
    from a host integer or a 0-dim integer tensor (a device tensor keeps the
    seeding free of host copies, as a captured CUDA graph needs)."""
    device = next(model.parameters()).device
    for m in model.modules():
        if isinstance(m, Dropout):
            m.manual_seed(seed, device)


class Tap(NamedTuple):
    """One in-bounds tap of a 3x3 atrous convolution: kernel position (iy,
    ix), the output rows [oy0, oy1) and columns [ox0, ox1) it reaches, and
    its source offset (dy, dx): out[oy, ox] += w[iy, ix] · x[oy + dy, ox + dx]."""

    iy: int
    ix: int
    oy0: int
    oy1: int
    ox0: int
    ox1: int
    dy: int
    dx: int


def atrous_taps(rate: int, H: int, W: int) -> list[Tap] | None:
    """The JAX ``_AtrousTapConv`` plan of a 3x3 convolution at dilation
    ``rate`` over an H x W input: None where it runs the dilated convolution
    (4·rate < min(H, W)), else its taps in the order it adds them (iy, then
    ix), those wholly in the padding left out."""
    if 4 * rate < min(H, W):
        return None
    taps = []
    for iy, dy in enumerate((-rate, 0, rate)):
        oy0, oy1 = max(0, -dy), min(H, H - dy)
        if oy1 <= oy0:
            continue
        for ix, dx in enumerate((-rate, 0, rate)):
            ox0, ox1 = max(0, -dx), min(W, W - dx)
            if ox1 > ox0:
                taps.append(Tap(iy, ix, oy0, oy1, ox0, ox1, dy, dx))
    return taps


class AtrousConv(Conv2d):
    """An ASPP branch's 3x3 atrous convolution (no bias), ``Conv2d``'s
    state-dict keys: JAX's tap plan ``taps(H, W)`` where it has one, else
    the dilated convolution."""

    def __init__(self, cin: int, cout: int, rate: int):
        super().__init__(cin, cout, 3, padding=rate, dilation=rate, bias=False)
        self.rate = rate

    def taps(self, H: int, W: int) -> list[Tap] | None:
        return atrous_taps(self.rate, H, W)

    def _forward(self, x: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
        taps = self.taps(*x.shape[-2:])
        if taps is None:
            return super()._forward(x, bias)
        # each tap's product from compute-dtype operands, exact in float32
        # (a product of two bfloat16 values fits its mantissa), accumulated
        # in float32 as JAX's preferred_element_type=float32, and the sum
        # rounded once
        dt = self.compute_dtype or self.weight.dtype
        acc = torch.promote_types(dt, torch.float32)
        xs = x.to(dt).to(acc).permute(0, 2, 3, 1)                    # [B,H,W,C]
        w = self.weight.to(dt).to(acc)                               # [F,C,3,3]
        out = xs.new_zeros(*xs.shape[:3], w.shape[0])
        for t in taps:
            src = xs[:, t.oy0 + t.dy:t.oy1 + t.dy, t.ox0 + t.dx:t.ox1 + t.dx]
            out[:, t.oy0:t.oy1, t.ox0:t.ox1] += src @ w[:, :, t.iy, t.ix].t()
        return out.permute(0, 3, 1, 2).to(dt)


def _conv_bn_relu(cin, cout, kernel=1, rate=None):
    conv = (Conv2d(cin, cout, kernel, padding=kernel // 2, bias=False) if rate is None
            else AtrousConv(cin, cout, rate))
    return [conv, BatchNorm2d(cout), nn.ReLU()]


class ASPP(nn.Module):
    def __init__(self, in_ch: int, features: int = 256, rates: Sequence[int] = (12, 24, 36),
                 dropout: float = 0.5):
        super().__init__()
        branches = [nn.Sequential(*_conv_bn_relu(in_ch, features))]
        branches += [nn.Sequential(*_conv_bn_relu(in_ch, features, 3, r)) for r in rates]
        branches.append(nn.Sequential(nn.AdaptiveAvgPool2d(1), *_conv_bn_relu(in_ch, features)))
        self.convs = nn.ModuleList(branches)
        self.project = nn.Sequential(*_conv_bn_relu(len(branches) * features, features),
                                     Dropout(dropout))

    def forward(self, x):
        out = [m(x) for m in self.convs[:-1]]
        out.append(self.convs[-1](x).expand(-1, -1, x.shape[-2], x.shape[-1]))
        return self.project(torch.cat(out, dim=1))


class DeepLabV3(nn.Module):
    """``forward``: [B,3,H,W] normalised float → [B,num_classes,H,W] float32
    logits. ``logits_nhwc`` is the same function in the JAX layout."""

    def __init__(self, num_classes: int = 2, backbone_depth: int = 50,
                 width_multiplier: float = 1.0, bn_frozen: bool = False, dtype="float32"):
        super().__init__()
        self.num_classes = num_classes
        self.backbone = ResNetBackbone(backbone_depth, width_multiplier,
                                       replace_stride_with_dilation=(False, True, True))
        head_ch = max(16, int(256 * width_multiplier))
        self.classifier = nn.Sequential(
            ASPP(self.backbone.feature_channels["layer4"], head_ch),
            *_conv_bn_relu(head_ch, head_ch, 3),
            Conv2d(head_ch, num_classes, 1),
        )
        for m in self.modules():
            if isinstance(m, BatchNorm2d):
                m.frozen = bn_frozen
        set_compute_dtype(self, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.classifier(self.backbone(x)["layer4"])
        return upsample_bilinear(y.float(), x.shape[-2:])

    def logits_nhwc(self, x: torch.Tensor) -> torch.Tensor:
        """[B,H,W,3] → [B,H,W,num_classes], as the JAX model's ``apply``."""
        return self(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
