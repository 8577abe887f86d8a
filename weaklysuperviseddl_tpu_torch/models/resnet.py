"""ResNet backbones (port of weaklysuperviseddl_tpu/models/resnet.py), NCHW.

torchvision's module and state-dict layout (``conv1``, ``bn1``,
``layerX.Y.*``, ``downsample.0/1``), so the JAX package's torch importer reads
the port's ``state_dict()`` unchanged. BN eps 1e-5; the max-pool pads with
-inf, as torch's does. ``BatchNorm2d`` updates its running variance in
training with the biased batch variance, as flax does (torch's own uses the
unbiased one).

Dilation follows torchvision's ``_make_layer``: when a stage is dilated its
first block keeps the *previous* dilation and its stride collapses to 1; the
remaining blocks use the accumulated dilation.

The JAX stem plans ``s2d`` and ``pack8`` are TPU layouts of the same 7x7/2
convolution; here the stem is that convolution (``StemConv``), which also
names the kernel shape JAX's default ``s2d`` plan convolves with, the stem's
fingerprint in an int8 calibration file (``ops/quant.py``).

The compute dtype is flax's ``dtype=`` (float32 or bfloat16): parameters,
BatchNorm statistics and the optimizer's state stay float32, while every
``Conv2d`` and ``Linear`` casts its input, kernel and bias to the compute
dtype and returns it (the product accumulates in float32), and every
``BatchNorm2d`` normalises in float32 and returns the compute dtype, so the
residual adds, ReLUs and pooling run in it. ``set_compute_dtype`` sets it on
a built model. float32 casts nothing: the layers are then torch's own and
compute in their parameters' type (float64 after ``model.double()``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from weaklysuperviseddl_tpu_torch.config import check_compute_dtype

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
STAGE_BLOCKS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3)}
BOTTLENECK_DEPTHS = (50,)


def compute_dtype(dtype) -> torch.dtype:
    """The torch dtype of a compute-dtype name ("float32", "bfloat16") or of
    a torch dtype; any other raises (``config.check_compute_dtype``)."""
    return COMPUTE_DTYPES[check_compute_dtype("dtype", str(dtype).removeprefix("torch."))]


def set_compute_dtype(model: nn.Module, dtype) -> nn.Module:
    """Set the compute dtype of every ``Conv2d``, ``Linear`` and
    ``BatchNorm2d`` of ``model`` (float32: none, so they compute in their
    parameters' type), and the ``compute_dtype`` that ``model`` and the
    models inside it report; the parameters are untouched. Returns the
    model."""
    dt = compute_dtype(dtype)
    model.compute_dtype = dt
    for m in model.modules():
        if isinstance(m, (Conv2d, Linear, BatchNorm2d)):
            m.compute_dtype = None if dt is torch.float32 else dt
        elif hasattr(m, "compute_dtype"):
            m.compute_dtype = dt
    return model


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` (same state-dict keys) in ``compute_dtype``: input,
    kernel and bias are cast to it, as flax's ``nn.Conv(dtype=...)`` does
    with its float32 parameters; None is ``nn.Conv2d``'s forward."""

    compute_dtype: torch.dtype | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class Linear(nn.Linear):
    """``nn.Linear`` (same state-dict keys) in ``compute_dtype``, as flax's
    ``nn.Dense(dtype=...)``; None is ``nn.Linear``'s forward."""

    compute_dtype: torch.dtype | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's running-statistics update in training:
    running = 0.9·running + 0.1·batch, where the batch variance is the biased
    one (torch's own module uses the unbiased one, which at the ASPP pooling
    branch, 4 values per channel at batch 4, is 4/3 too large). Eval mode and
    the state-dict keys are ``nn.BatchNorm2d``'s.

    ``frozen`` (set by ``DeepLabV3(bn_frozen=True)``): the layer normalises
    with its running statistics and leaves them untouched even in training
    mode; gradients still reach its affine weight and bias.

    The statistics and the normalisation are float32 whatever the input's
    dtype; the output is ``compute_dtype`` where one is set (flax's
    ``nn.BatchNorm(dtype=...)``), else the input's."""

    frozen = False
    compute_dtype: torch.dtype | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.frozen:
            return self._out(F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                          self.bias, False, 0.0, self.eps))
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        with torch.no_grad():
            dims = [0] + list(range(2, x.ndim))
            xf = x.float()
            mean = xf.mean(dim=dims)
            var = xf.var(dim=dims, unbiased=False)
            self.running_mean.mul_(1.0 - self.momentum).add_(self.momentum * mean)
            self.running_var.mul_(1.0 - self.momentum).add_(self.momentum * var)
            self.num_batches_tracked.add_(1)
        return self._out(y)

    def _out(self, y: torch.Tensor) -> torch.Tensor:
        return y if self.compute_dtype is None else y.to(self.compute_dtype)


class StemConv(Conv2d):
    """The 7x7/2 stem convolution (padding 3, no bias): ``Conv2d``'s forward
    and state-dict keys, unchanged."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 7, stride=2, padding=3, bias=False)

    def jax_kernel_shape(self, H: int, W: int) -> list[int]:
        """The HWIO shape of the kernel the JAX stem convolves an H x W input
        with: its ``s2d`` plan's [4, 4, 4·C, F] (the 7x7 kernel padded to 8x8
        and folded 2x2 into the channels) where H and W are even, else the
        direct [7, 7, C, F]. The products are the same: the padded entries
        are zero."""
        C, F = self.in_channels, self.out_channels
        return [7, 7, C, F] if H % 2 or W % 2 else [4, 4, 4 * C, F]


def _conv(cin, cout, kernel, stride=1, dilation=1):
    return Conv2d(cin, cout, kernel, stride=stride, padding=(kernel // 2) * dilation,
                  dilation=dilation, bias=False)


class BasicBlock(nn.Module):
    """2x 3x3 conv + residual (ResNet-18/34)."""

    expansion = 1

    def __init__(self, inplanes, planes, stride=1, dilation=1, downsample=None):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride, dilation)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, 1, dilation)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = downsample

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        res = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + res)


class BasicBlockDe(nn.Module):
    """Decoder BasicBlock whose residual path is a conv + BN + ReLU instead of
    the identity (BASNet's block family; the reference's ``resnet_model.py``)."""

    expansion = 1

    def __init__(self, inplanes, planes, stride=1, dilation=1):
        super().__init__()
        self.convRes = _conv(inplanes, planes, 3, stride, dilation)
        self.bnRes = BatchNorm2d(planes)
        self.conv1 = _conv(inplanes, planes, 3, stride, dilation)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, 1, dilation)
        self.bn2 = BatchNorm2d(planes)

    def forward(self, x):
        res = torch.relu(self.bnRes(self.convRes(x)))
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return torch.relu(out + res)


class Bottleneck(nn.Module):
    """1-3-1 bottleneck, expansion 4 (ResNet-50)."""

    expansion = 4

    def __init__(self, inplanes, planes, stride=1, dilation=1, downsample=None):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, stride, dilation)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = BatchNorm2d(planes * 4)
        self.downsample = downsample

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        res = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + res)


class ResNetBackbone(nn.Module):
    """Stem + 4 stages; ``forward`` returns the feature pyramid as a dict
    (``stem``, ``layer1`` … ``layer4``). ``replace_stride_with_dilation``
    applies to (layer2, layer3, layer4) as in torchvision; ``width_multiplier``
    shrinks channel counts (``max(8, int(c * wm))``) for small test models;
    ``dtype`` is the compute dtype (``set_compute_dtype``)."""

    def __init__(self, depth: int = 50, width_multiplier: float = 1.0,
                 replace_stride_with_dilation: Sequence[bool] = (False, False, True),
                 dtype="float32"):
        super().__init__()
        self.depth = depth
        self.width_multiplier = width_multiplier
        block = Bottleneck if depth in BOTTLENECK_DEPTHS else BasicBlock
        stem = self._width(64)
        self.conv1 = StemConv(3, stem)
        self.bn1 = BatchNorm2d(stem)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)

        inplanes, dilation = stem, 1
        for i, (num_blocks, base) in enumerate(zip(STAGE_BLOCKS[depth], (64, 128, 256, 512))):
            planes = self._width(base)
            stride = 1 if i == 0 else 2
            previous_dilation = dilation
            if i > 0 and replace_stride_with_dilation[i - 1]:
                dilation *= stride
                stride = 1
            out_ch = planes * block.expansion
            downsample = None
            if stride != 1 or inplanes != out_ch:
                downsample = nn.Sequential(_conv(inplanes, out_ch, 1, stride), BatchNorm2d(out_ch))
            blocks = [block(inplanes, planes, stride, previous_dilation, downsample)]
            blocks += [block(out_ch, planes, 1, dilation) for _ in range(1, num_blocks)]
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
            inplanes = out_ch
        set_compute_dtype(self, dtype)

    def _width(self, c: int) -> int:
        return max(8, int(c * self.width_multiplier))

    @property
    def feature_channels(self) -> dict[str, int]:
        expansion = 4 if self.depth in BOTTLENECK_DEPTHS else 1
        return {f"layer{i + 1}": self._width(c) * expansion
                for i, c in enumerate((64, 128, 256, 512))}

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        feats = {"stem": x}
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
            feats[f"layer{i}"] = x
        return feats


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights: convolutions and linear layers from
    N(0, 1/fan_in) (LeCun normal), biases zero, BN at identity (scale 1, shift
    0, mean 0, var 1). Drawn on the CPU from ``generator`` so a seed gives the
    same weights on any device."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            w = torch.randn(m.weight.shape, generator=generator) * fan_in ** -0.5
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    return module
