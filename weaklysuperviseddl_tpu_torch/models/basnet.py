"""BASNet, the boundary-aware saliency network (port of
weaklysuperviseddl_tpu/models/basnet.py), NCHW.

The reference's architecture (``PretrainedBasnetModel/model/BASNet.py``): an
input conv, ResNet-34 encoder stages 1-4, two more stages of three 512-channel
BasicBlocks behind ceil-mode max-pools, a bridge of three dilated convs, a
six-stage U-decoder with skip concatenations, seven side-output heads
upsampled bilinearly to the input size, and the RefUnet residual refiner. The
forward returns eight sigmoid maps ``(dout, d1, ..., d6, db)``, each
[B, n_classes, H, W].

Module names are the reference's state-dict keys (``inconv``, ``inbn``,
``encoder1.0.conv1``, ``resb5_1``, ``convbg_1``, ``bnbg_m``, ``conv6d_1``,
``outconvb``, ``refunet.conv_d0``, ...), so its ``basnet.pth`` loads with
``load_state_dict(strict=True)`` and the JAX package's torch importer reads
the port's ``state_dict()`` unchanged. BASNet's own convs carry biases; the
ResNet blocks' do not. BatchNorm is ``models/resnet.BatchNorm2d`` (flax's
running-statistics rule, as the JAX model's ``momentum=0.9``). ``dtype`` is
the compute dtype (``models/resnet.set_compute_dtype``) of every conv and
BatchNorm, the RefUnet and the side outputs; the eight maps come back in it,
their sigmoids taken in it, as in the JAX model.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from weaklysuperviseddl_tpu_torch.models.resnet import (
    BasicBlock,
    BatchNorm2d,
    Conv2d,
    _conv,
    set_compute_dtype,
)
from weaklysuperviseddl_tpu_torch.ops.resize import resize_bilinear


def _conv_b(cin: int, cout: int, kernel: int = 3, dilation: int = 1) -> Conv2d:
    """A conv with bias and symmetric padding that keeps the spatial size."""
    return Conv2d(cin, cout, kernel, padding=(kernel // 2) * dilation, dilation=dilation)


def _pool2(x: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(2, 2, ceil_mode=True): an odd edge keeps its last row or
    column, as JAX's pool over a -inf pad does."""
    return nn.functional.max_pool2d(x, 2, 2, ceil_mode=True)


def _up_to(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return resize_bilinear(x, (h, w), axes=(2, 3))


def _up2(x: torch.Tensor) -> torch.Tensor:
    return _up_to(x, x.shape[2] * 2, x.shape[3] * 2)


class RefUnet(nn.Module):
    """Residual refinement U-Net (the reference's ``BASNet.py:9-102``): a
    4-level encoder-decoder of 64-channel convs whose 1-channel output is
    added to its input."""

    def __init__(self, in_ch: int = 1, inc_ch: int = 64):
        super().__init__()
        self.conv0 = _conv_b(in_ch, inc_ch)
        for i in range(1, 6):
            setattr(self, f"conv{i}", _conv_b(64, 64))
            setattr(self, f"bn{i}", BatchNorm2d(64))
        for i in range(4, 0, -1):
            setattr(self, f"conv_d{i}", _conv_b(128, 64))
            setattr(self, f"bn_d{i}", BatchNorm2d(64))
        self.conv_d0 = _conv_b(64, 1)

    def _cbr(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(getattr(self, f"bn{name}")(getattr(self, f"conv{name}")(x)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hx = self.conv0(x)
        skips = []
        for i in range(1, 5):
            skips.append(self._cbr(str(i), hx))
            hx = _pool2(skips[-1])
        hx = self._cbr("5", hx)
        for i in range(4, 0, -1):
            hx = self._cbr(f"_d{i}", torch.cat([_up2(hx), skips[i - 1]], 1))
        return x + self.conv_d0(hx)


# (stage, blocks, planes, first stride) of the ResNet-34 encoder
_ENCODER = (("encoder1", 3, 64, 1), ("encoder2", 4, 128, 2), ("encoder3", 6, 256, 2),
            ("encoder4", 3, 512, 2))
# (name, input channels, c1, cm, c2, dilation of the _m and _2 convs) of the decoder
_DECODER = (("6d", 1024, 512, 512, 512, 2), ("5d", 1024, 512, 512, 512, 1),
            ("4d", 1024, 512, 512, 256, 1), ("3d", 512, 256, 256, 128, 1),
            ("2d", 256, 128, 128, 64, 1), ("1d", 128, 64, 64, 64, 1))


def _stage(inplanes: int, planes: int, num_blocks: int, stride: int) -> nn.Sequential:
    downsample = None
    if stride != 1 or inplanes != planes:
        downsample = nn.Sequential(_conv(inplanes, planes, 1, stride), BatchNorm2d(planes))
    blocks = [BasicBlock(inplanes, planes, stride, downsample=downsample)]
    blocks += [BasicBlock(planes, planes) for _ in range(1, num_blocks)]
    return nn.Sequential(*blocks)


class BASNet(nn.Module):
    def __init__(self, n_channels: int = 3, n_classes: int = 1, dtype="float32"):
        super().__init__()
        self.inconv = _conv_b(n_channels, 64)
        self.inbn = BatchNorm2d(64)
        inplanes = 64
        for name, blocks, planes, stride in _ENCODER:
            setattr(self, name, _stage(inplanes, planes, blocks, stride))
            inplanes = planes
        for s in (5, 6):
            for i in range(1, 4):
                setattr(self, f"resb{s}_{i}", BasicBlock(512, 512))
        for part, cin, dil in (("1", 512, 2), ("m", 512, 2), ("2", 512, 2)):
            setattr(self, f"convbg_{part}", _conv_b(cin, 512, dilation=dil))
            setattr(self, f"bnbg_{part}", BatchNorm2d(512))
        for name, cin, c1, cm, c2, dil in _DECODER:
            for part, ci, co, d in (("1", cin, c1, 1), ("m", c1, cm, dil), ("2", cm, c2, dil)):
                setattr(self, f"conv{name}_{part}", _conv_b(ci, co, dilation=d))
                setattr(self, f"bn{name}_{part}", BatchNorm2d(co))
        self.outconvb = _conv_b(512, n_classes)
        for i, cin in ((6, 512), (5, 512), (4, 256), (3, 128), (2, 64), (1, 64)):
            setattr(self, f"outconv{i}", _conv_b(cin, n_classes))
        self.refunet = RefUnet(n_classes, 64)
        set_compute_dtype(self, dtype)

    def _cbr(self, conv: str, bn: str, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(getattr(self, bn)(getattr(self, conv)(x)))

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        H, W = x.shape[2], x.shape[3]
        hx = self._cbr("inconv", "inbn", x)
        h1 = self.encoder1(hx)                # full size
        h2 = self.encoder2(h1)                # /2
        h3 = self.encoder3(h2)                # /4
        h4 = self.encoder4(h3)                # /8
        h5 = self.resb5_3(self.resb5_2(self.resb5_1(_pool2(h4))))   # /16
        h6 = self.resb6_3(self.resb6_2(self.resb6_1(_pool2(h5))))   # /32

        hx = h6
        for part in ("1", "m", "2"):          # the bridge
            hx = self._cbr(f"convbg_{part}", f"bnbg_{part}", hx)
        hbg = hx

        decoded = []
        hx = torch.cat([hbg, h6], 1)
        for (name, *_), skip in zip(_DECODER, (h5, h4, h3, h2, h1, None)):
            for part in ("1", "m", "2"):
                hx = self._cbr(f"conv{name}_{part}", f"bn{name}_{part}", hx)
            decoded.append(hx)
            if skip is not None:
                hx = torch.cat([_up2(hx), skip], 1)
        hd6, hd5, hd4, hd3, hd2, hd1 = decoded

        db = _up_to(self.outconvb(hbg), H, W)
        d6 = _up_to(self.outconv6(hd6), H, W)
        d5 = _up_to(self.outconv5(hd5), H, W)
        d4 = _up_to(self.outconv4(hd4), H, W)
        d3 = _up_to(self.outconv3(hd3), H, W)
        d2 = _up_to(self.outconv2(hd2), H, W)
        d1 = self.outconv1(hd1)
        dout = self.refunet(d1)
        return tuple(torch.sigmoid(d) for d in (dout, d1, d2, d3, d4, d5, d6, db))
