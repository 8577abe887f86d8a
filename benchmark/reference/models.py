"""Plain PyTorch models the benchmark holds the program to: torchvision's
ResNet-50 and DeepLabV3 as published, in torchvision's module layout and
state-dict keys, built from ``torch.nn`` alone.

* ``ResNet50``: the bottleneck ResNet-50 (He et al., arXiv:1512.03385), its
  stages dilated where ``dilate`` says (torchvision's
  ``replace_stride_with_dilation``: a dilated stage's first block keeps the
  previous dilation and its stride becomes 1).
* ``DeepLabV3``: ResNet-50 at output stride 8 (layer3 and layer4 dilated),
  the ASPP (a 1x1 branch, 3x3 branches at rates 12/24/36 and an image-pooling
  branch, each to 256 channels with BatchNorm and ReLU; concat, 1x1 project,
  BatchNorm, ReLU, dropout 0.5), a 3x3 conv, BatchNorm, ReLU and a 1x1
  classifier with bias (Chen et al., arXiv:1706.05587; torchvision's
  ``deeplabv3_resnet50``), logits upsampled bilinearly (half-pixel centres)
  to the input size.
* ``Classifier``: ResNet-50 with layer4 dilated, global average pooling and a
  linear layer to the classes.

BatchNorm normalises with the batch's biased variance in training, eps 1e-5.
The dropout's mask is a function of a key and of each element's index
(``reference/dropout.py``), so that a seed fixes it on both sides.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.dropout import keep_mask


def _conv(cin, cout, k, stride=1, dilation=1):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=(k // 2) * dilation,
                     dilation=dilation, bias=False)


class Bottleneck(nn.Module):
    def __init__(self, inplanes, planes, stride=1, dilation=1, downsample=None):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, stride, dilation)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = downsample

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + (x if self.downsample is None else self.downsample(x)))


class ResNet50(nn.Module):
    """Stem and four stages; ``forward`` returns {"layer1": ..., "layer4": ...}.
    ``width`` scales every channel count (1.0 is the published model; the
    tests use smaller widths on the CPU)."""

    def __init__(self, dilate=(False, False, False), width: float = 1.0):
        super().__init__()
        c = lambda n: max(8, int(n * width))  # noqa: E731
        self.conv1 = nn.Conv2d(3, c(64), 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(c(64))
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        inplanes, dilation = c(64), 1
        for i, (blocks, base) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512))):
            planes, stride = c(base), (1 if i == 0 else 2)
            previous = dilation
            if i > 0 and dilate[i - 1]:
                dilation *= stride
                stride = 1
            down = None
            if stride != 1 or inplanes != planes * 4:
                down = nn.Sequential(_conv(inplanes, planes * 4, 1, stride),
                                     nn.BatchNorm2d(planes * 4))
            layers = [Bottleneck(inplanes, planes, stride, previous, down)]
            layers += [Bottleneck(planes * 4, planes, 1, dilation) for _ in range(1, blocks)]
            setattr(self, f"layer{i + 1}", nn.Sequential(*layers))
            inplanes = planes * 4
        self.channels = inplanes

    def forward(self, x):
        x = self.maxpool(F.relu(self.bn1(self.conv1(x))))
        out = {}
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
            out[f"layer{i}"] = x
        return out


class KeyedDropout(nn.Module):
    """Dropout whose mask is ``keep_mask(key, shape)``; ``key`` is set before
    each training step (None: the identity)."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = p
        self.key: int | None = None

    def forward(self, x):
        if not self.training or self.key is None:
            return x
        keep = keep_mask(self.key, x.shape, self.p, x.device)
        return x * keep.to(x.dtype) / (1.0 - self.p)


def _branch(cin, cout, k=1, rate=1):
    conv = nn.Conv2d(cin, cout, k, padding=(k // 2) * rate, dilation=rate, bias=False)
    return [conv, nn.BatchNorm2d(cout), nn.ReLU()]


class ASPP(nn.Module):
    def __init__(self, cin, features=256, rates=(12, 24, 36), dropout=0.5):
        super().__init__()
        branches = [nn.Sequential(*_branch(cin, features))]
        branches += [nn.Sequential(*_branch(cin, features, 3, r)) for r in rates]
        branches.append(nn.Sequential(nn.AdaptiveAvgPool2d(1), *_branch(cin, features)))
        self.convs = nn.ModuleList(branches)
        self.project = nn.Sequential(*_branch(len(branches) * features, features),
                                     KeyedDropout(dropout))

    def forward(self, x):
        out = [m(x) for m in self.convs[:-1]]
        pooled = self.convs[-1](x)
        out.append(pooled.expand(-1, -1, x.shape[-2], x.shape[-1]))
        return self.project(torch.cat(out, dim=1))


class DeepLabV3(nn.Module):
    """[B,3,H,W] normalised images → [B,num_classes,H,W] logits."""

    def __init__(self, num_classes=2, rates=(12, 24, 36), features=256, dropout=0.5,
                 width: float = 1.0):
        super().__init__()
        self.backbone = ResNet50(dilate=(False, True, True), width=width)
        head = max(16, int(features * width))
        self.classifier = nn.Sequential(
            ASPP(self.backbone.channels, head, rates, dropout),
            *_branch(head, head, 3),
            nn.Conv2d(head, num_classes, 1),
        )

    @property
    def dropout(self) -> KeyedDropout:
        return self.classifier[0].project[3]

    def forward(self, x):
        y = self.classifier(self.backbone(x)["layer4"])
        return F.interpolate(y, size=x.shape[-2:], mode="bilinear", align_corners=False)


class Classifier(ResNet50):
    """ResNet-50 (layer4 dilated) → global average pool → linear, in
    torchvision's resnet layout (``conv1`` … ``layer4``, ``fc``). ``forward``
    returns (logits, {"layer1": ..., "layer4": ...})."""

    def __init__(self, num_classes=37, width: float = 1.0):
        super().__init__(dilate=(False, False, True), width=width)
        self.fc = nn.Linear(self.channels, num_classes)

    def forward(self, x):
        feats = super().forward(x)
        return self.fc(feats["layer4"].mean(dim=(2, 3))), feats
