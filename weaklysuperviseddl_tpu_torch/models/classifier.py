"""Frozen-ResNet CAM classifier (port of weaklysuperviseddl_tpu/models/classifier.py;
ref TraditionalModel/ClassificationModel.py:9-41), NCHW.

A ``ResNetBackbone`` (layer4 dilated by default) plus an ``fc``
``nn.Linear``, in torchvision's resnet key layout, so the JAX package's
``torch_import.cam_classifier_variables`` reads the port's ``state_dict()``
unchanged. BatchNorm always uses the running statistics, whatever mode the
module is in (the JAX model calls its backbone with ``train=False``); only
the fc is trained (``train/classifier.py``). ``dtype`` is the compute dtype
(``models/resnet.set_compute_dtype``): in bfloat16 the activations and the
logits come back in bfloat16, as the JAX model's do.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from weaklysuperviseddl_tpu_torch.models.resnet import Linear, ResNetBackbone, set_compute_dtype


class CamClassifier(ResNetBackbone):
    def __init__(self, num_classes: int = 37, depth: int = 50, width_multiplier: float = 1.0,
                 dilate_layer4: bool = True, dtype="float32"):
        super().__init__(depth, width_multiplier,
                         replace_stride_with_dilation=(False, False, dilate_layer4))
        self.num_classes = num_classes
        self.fc = Linear(self.feature_channels["layer4"], num_classes)
        set_compute_dtype(self, dtype)
        self.eval()

    def train(self, mode: bool = True):
        super().train(mode)
        for m in self.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.eval()
        return self

    def features(self, x: torch.Tensor):
        """[B,3,H,W] → (logits [B,num_classes], the named feature pyramid), in
        the compute dtype; the pooling, as JAX's mean, in that dtype too."""
        feats = super().forward(x)
        logits = self.fc(feats["layer4"].mean(dim=(2, 3)))  # AdaptiveAvgPool2d((1,1))
        return logits, feats

    def forward(self, x: torch.Tensor):
        """[B,3,H,W] → (logits [B,num_classes], [f2, f3, f4])."""
        logits, feats = self.features(x)
        return logits, [feats["layer2"], feats["layer3"], feats["layer4"]]
