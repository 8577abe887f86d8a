"""JAX variable tree → the port's ``state_dict`` (carries weights across).

The exact inverses of the JAX package's ``models/torch_import.deeplab_variables``
and ``cam_classifier_variables``: they take the JAX model's ``{"params",
"batch_stats"}`` with numpy leaves and return the torchvision-layout state
dict that ``models/deeplabv3.DeepLabV3`` or ``models/classifier.CamClassifier``
loads. Only numpy crosses between the two packages.

Layout conversions:
  conv kernel (kh,kw,I,O)   → weight (O,I,kh,kw)
  dense kernel (I,O)        → weight (O,I)
  bn   scale/bias           → weight/bias
       batch_stats mean/var → running_mean/running_var (+ num_batches_tracked 0)
Key rewrites: ``layerX_Y`` → ``layerX.Y``; ``downsample_conv/bn`` →
``downsample.0/1``; the ASPP and head names → torchvision's ``classifier.*``.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch

_HEAD = {
    "aspp.conv1x1": "classifier.0.convs.0.0",
    "aspp.bn1x1": "classifier.0.convs.0.1",
    "aspp.pool_conv": "classifier.0.convs.4.1",
    "aspp.pool_bn": "classifier.0.convs.4.2",
    "aspp.project": "classifier.0.project.0",
    "aspp.project_bn": "classifier.0.project.1",
    "head_conv": "classifier.1",
    "head_bn": "classifier.2",
    "classifier": "classifier.4",
}


def _flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(_flatten(value, path + "."))
        else:
            out[path] = np.asarray(value)
    return out


def _module_name(path: str) -> str:
    """JAX module path → torchvision module name."""
    m = re.match(r"^aspp\.atrous(_bn)?(\d)$", path)
    if m:
        return f"classifier.0.convs.{int(m.group(2)) + 1}.{1 if m.group(1) else 0}"
    if path in _HEAD:
        return _HEAD[path]
    path = re.sub(r"(layer\d)_(\d+)", r"\1.\2", path)
    return path.replace("downsample_conv", "downsample.0").replace("downsample_bn", "downsample.1")


def deeplab_state_dict_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """JAX DeepLabV3 ``{"params", "batch_stats"}`` → the port's state dict."""
    return _state_dict(variables["params"], variables["batch_stats"])


def cam_classifier_state_dict_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """JAX CamClassifier ``{"params": {"backbone", "fc"}, "batch_stats":
    {"backbone"}}`` → the port's ``CamClassifier`` state dict, the inverse of
    ``torch_import.cam_classifier_variables``: the backbone at top level, the
    Dense kernel (I,O) → the Linear weight (O,I)."""
    params = dict(variables["params"]["backbone"])
    params["fc"] = variables["params"]["fc"]
    return _state_dict(params, variables["batch_stats"]["backbone"])


def _state_dict(params: Mapping, batch_stats: Mapping) -> dict[str, torch.Tensor]:
    sd: dict[str, torch.Tensor] = {}
    for path, value in _flatten(params).items():
        module, leaf = path.rsplit(".", 1)
        name = _module_name(module)
        if leaf == "kernel" and value.ndim == 2:  # Dense
            sd[f"{name}.weight"] = torch.from_numpy(value.T.copy())
        elif leaf == "kernel":
            if value.ndim != 4:
                raise ValueError(f"unexpected kernel rank for {path}: {value.shape}")
            sd[f"{name}.weight"] = torch.from_numpy(value.transpose(3, 2, 0, 1).copy())
        elif leaf == "scale":
            sd[f"{name}.weight"] = torch.from_numpy(value.copy())
        elif leaf == "bias":
            sd[f"{name}.bias"] = torch.from_numpy(value.copy())
        else:
            raise ValueError(f"unhandled parameter {path}")
    for path, value in _flatten(batch_stats).items():
        module, leaf = path.rsplit(".", 1)
        name = _module_name(module)
        if leaf not in ("mean", "var"):
            raise ValueError(f"unhandled batch statistic {path}")
        sd[f"{name}.running_{leaf}"] = torch.from_numpy(value.copy())
        sd[f"{name}.num_batches_tracked"] = torch.tensor(0)
    return sd
