"""Reference surface: TraditionalModel/ClassificationModel.py (port of
weaklysuperviseddl_tpu/compat/ClassificationModel.py).

``FrozenResNetCAM`` is the port's ``CamClassifier`` (ResNet, layer4 dilated,
an fc over the pooled features) with the reference's contract
(ClassificationModel.py:9-41): calling it gives ``(logits, [f2, f3, f4])``,
NCHW, for an image in any layout ``_adapt.to_nhwc`` takes; ``state_dict``
has torchvision's keys, and ``load_state_dict`` also reads the reference's
own ``.pth``, whose stem is ``layer0.0.``/``layer0.1.``; ``.to``, ``.eval``
and ``.train`` are ``nn.Module``'s (``.to`` moves the weights, where JAX's
is a no-op).
"""

from __future__ import annotations

import functools
import re

import torch

from weaklysuperviseddl_tpu_torch.compat._adapt import float_images, model_device
from weaklysuperviseddl_tpu_torch.data.loader import Batch, batches
from weaklysuperviseddl_tpu_torch.device import resolve_device
from weaklysuperviseddl_tpu_torch.models.classifier import CamClassifier
from weaklysuperviseddl_tpu_torch.models.resnet import init_weights
from weaklysuperviseddl_tpu_torch.train import classifier as _train

# the reference FrozenResNetCAM's stem (ClassificationModel.py:18) → torchvision's
_STEM = ((re.compile(r"^layer0\.0\."), "conv1."), (re.compile(r"^layer0\.1\."), "bn1."))


def _reference_keys(state_dict: dict) -> dict:
    """A state dict with the reference's stem keys renamed to torchvision's
    (the JAX package's ``torch_import`` rewrite)."""
    out = {}
    for key, value in state_dict.items():
        for pattern, repl in _STEM:
            key = pattern.sub(repl, key)
        out[key] = value
    return out


class FrozenResNetCAM(CamClassifier):
    """``seed``: the random weights' seed (``init_weights``; not JAX's flax
    init). ``device``: where the model lives (None: the card)."""

    def __init__(self, num_classes: int = 37, depth: int = 50, width_multiplier: float = 1.0,
                 seed: int = 0, device=None, **_ignored):
        dev = resolve_device(device)
        super().__init__(num_classes=num_classes, depth=depth,
                         width_multiplier=width_multiplier, dilate_layer4=True)
        init_weights(self, torch.Generator().manual_seed(seed))
        self.to(dev)

    def forward(self, x):
        """An image or a batch in any layout → (logits, [f2, f3, f4])."""
        return super().forward(float_images(x, model_device(self)).permute(0, 3, 1, 2))

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        return super().load_state_dict(_reference_keys(state_dict), strict=strict, assign=assign)


def _as_loader_fn(dataloader):
    """Adapt a zero-argument factory of Batch iterators, or an iterable of Batch objects."""
    if callable(dataloader):
        return dataloader
    cached = dataloader if isinstance(dataloader, list) else list(dataloader)
    if cached and isinstance(cached[0], Batch):
        return lambda: iter(cached)
    raise TypeError(
        "compat train_fc_only expects an iterable of weaklysuperviseddl_tpu_torch Batch "
        "objects (use data.loader.batches) or a zero-arg factory returning one")


def train_fc_only(model: FrozenResNetCAM, dataloader=None, device=None, epochs: int = 10,
                  num_classes: int = 37, lr: float = 1e-3, image_size: int = 224, log=print):
    """Both reference signatures: ``(model, device, epochs, num_classes)``
    (ClassificationModel.py:70), which trains on the split loaders of
    ``load_split_data``, and ``(model, dataloader, device, epochs)``
    (AlternatingDirectionCutLoss.py:116). The model moves to ``device``
    (None: the card) and its fc is trained in place; returns the model."""
    if dataloader is None or isinstance(dataloader, (str, torch.device)):
        from weaklysuperviseddl_tpu_torch.data.dataset import load_split_data

        device = dataloader if dataloader is not None else device
        train_ds, val_ds = load_split_data(None)
        train_loader_fn = functools.partial(batches, train_ds, 32, shuffle=True,
                                            pad_to_full=True)
        val_loader_fn = functools.partial(batches, val_ds, 8)
    else:
        train_loader_fn = _as_loader_fn(dataloader)
        val_loader_fn = None
    model.to(resolve_device(device))
    return _train.train_fc_only(model, train_loader_fn, val_loader_fn, epochs=epochs, lr=lr,
                                num_classes=num_classes, image_size=image_size, log=log)


def evaluate_classification(model: FrozenResNetCAM, dataloader, device=None,
                            num_classes: int = 37, image_size: int = 224, log=print):
    """Reference signature (ClassificationModel.py:109-150): (accuracy %,
    macro-F1) on ``device`` (None: the card)."""
    model.to(resolve_device(device))
    return _train.evaluate_classification(model, _as_loader_fn(dataloader)(),
                                          num_classes=num_classes, image_size=image_size,
                                          log=log)
