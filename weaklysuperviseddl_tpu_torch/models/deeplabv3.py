"""DeepLabV3 (port of weaklysuperviseddl_tpu/models/deeplabv3.py), NCHW.

torchvision's ``deeplabv3_resnet50`` layout and state-dict keys:

  * ResNet backbone at output stride 8 (layer3 and layer4 dilated)
  * ``classifier.0``: ASPP over layer4 — 1x1 conv, three 3x3 atrous convs
    (rates 12/24/36) and an image-pooling branch, each → ``head_ch`` BN ReLU;
    concat → 1x1 project → BN → ReLU → Dropout(0.5)
  * ``classifier.1-3``: 3x3 conv → BN → ReLU; ``classifier.4``: 1x1 conv to
    ``num_classes`` (with bias)
  * bilinear upsample of the logits to the input size (align_corners=False)

The JAX ``_AtrousTapConv`` is a TPU layout of the same zero-padded dilated
convolution; here it is ``Conv2d(padding=rate, dilation=rate)``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from weaklysuperviseddl_tpu_torch.models.resnet import BatchNorm2d, ResNetBackbone


def _conv_bn_relu(cin, cout, kernel=1, rate=1):
    return [nn.Conv2d(cin, cout, kernel, padding=rate if kernel == 3 else 0,
                      dilation=rate, bias=False),
            BatchNorm2d(cout), nn.ReLU()]


class ASPP(nn.Module):
    def __init__(self, in_ch: int, features: int = 256, rates: Sequence[int] = (12, 24, 36),
                 dropout: float = 0.5):
        super().__init__()
        branches = [nn.Sequential(*_conv_bn_relu(in_ch, features))]
        branches += [nn.Sequential(*_conv_bn_relu(in_ch, features, 3, r)) for r in rates]
        branches.append(nn.Sequential(nn.AdaptiveAvgPool2d(1), *_conv_bn_relu(in_ch, features)))
        self.convs = nn.ModuleList(branches)
        self.project = nn.Sequential(*_conv_bn_relu(len(branches) * features, features),
                                     nn.Dropout(dropout))

    def forward(self, x):
        out = [m(x) for m in self.convs[:-1]]
        out.append(self.convs[-1](x).expand(-1, -1, x.shape[-2], x.shape[-1]))
        return self.project(torch.cat(out, dim=1))


class DeepLabV3(nn.Module):
    """``forward``: [B,3,H,W] normalised float → [B,num_classes,H,W] logits.
    ``logits_nhwc`` is the same function in the JAX layout."""

    def __init__(self, num_classes: int = 2, backbone_depth: int = 50,
                 width_multiplier: float = 1.0):
        super().__init__()
        self.num_classes = num_classes
        self.backbone = ResNetBackbone(backbone_depth, width_multiplier,
                                       replace_stride_with_dilation=(False, True, True))
        head_ch = max(16, int(256 * width_multiplier))
        self.classifier = nn.Sequential(
            ASPP(self.backbone.feature_channels["layer4"], head_ch),
            *_conv_bn_relu(head_ch, head_ch, 3),
            nn.Conv2d(head_ch, num_classes, 1),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.classifier(self.backbone(x)["layer4"])
        return F.interpolate(y.float(), size=x.shape[-2:], mode="bilinear",
                             align_corners=False)

    def logits_nhwc(self, x: torch.Tensor) -> torch.Tensor:
        """[B,H,W,3] → [B,H,W,num_classes], as the JAX model's ``apply``."""
        return self(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
