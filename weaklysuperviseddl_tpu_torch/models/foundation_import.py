"""The weights bridge of the foundation baseline: ``transformers`` state dicts
(numpy arrays or tensors, from a ``model.safetensors`` or a model in memory)
into the port's SAM and GroundingDINO, and hub names to local snapshots.

Checks are strict, as ``utils/checkpoint.py``'s: a missing or unexpected key,
a shape or a dtype that differs raises a ``ValueError`` naming the first
such key. ``save_pretrained`` writes tied weights once; they are re-tied
here: SAM's ``prompt_encoder.shared_embedding.positional_embedding``
(``modeling_sam.py:1113``) and GroundingDINO's ``bbox_embed.N`` /
``model.decoder.bbox_embed.N`` (``modeling_grounding_dino.py:2416-2430``).
Swin's ``relative_position_index`` buffers follow from the window size; a
checkpoint without them keeps the model's own.

A hub name (``facebook/sam-vit-base``, ``IDEA-Research/grounding-dino-base``)
resolves to ``models--ORG--NAME/snapshots/<refs/main>/`` under
``HF_HUB_CACHE``, else ``HF_HOME/hub``, else ``~/.cache/huggingface/hub``.
Nothing is downloaded: a missing snapshot or file raises
``FileNotFoundError`` naming the path.
"""

from __future__ import annotations

import json
import os
import re
from collections.abc import Mapping
from pathlib import Path

import numpy as np
import torch

from weaklysuperviseddl_tpu_torch.models.foundation_config import GroundingDinoConfig, SamConfig
from weaklysuperviseddl_tpu_torch.models.safetensors_io import read_safetensors
from weaklysuperviseddl_tpu_torch.models.sam.model import TIED_KEYS as SAM_TIED

_BBOX = re.compile(r"^(?:model\.decoder\.)?bbox_embed\.(\d+)\.(.+)$")
_DERIVED = re.compile(r"relative_position_index$")


def _as_tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu()
    return torch.from_numpy(np.array(v, copy=True))


def _tie(state: dict, groups: dict[str, list[str]]) -> None:
    """Fill each missing key of a tied group from a present one."""
    for keys in groups.values():
        present = [k for k in keys if k in state]
        for k in keys:
            if k not in state and present:
                state[k] = state[present[0]]


def _gdino_groups(template: Mapping, shared: bool) -> dict[str, list[str]]:
    groups: dict[str, list[str]] = {}
    for k in template:
        m = _BBOX.match(k)
        if m:
            groups.setdefault(m.group(2) if shared else f"{m.group(1)}.{m.group(2)}", []).append(k)
    return groups


def port_state_dict(model: torch.nn.Module, state: Mapping) -> dict[str, torch.Tensor]:
    """``state`` checked against ``model.state_dict()`` and re-tied: the
    state dict ``model.load_state_dict`` takes."""
    template = model.state_dict()
    state = {k: _as_tensor(v) for k, v in state.items()}
    if hasattr(model, "prompt_encoder"):
        groups = {v: [k, v] for k, v in SAM_TIED.items()}
    else:
        groups = _gdino_groups(template, model.config.decoder_bbox_embed_share)
    _tie(state, groups)
    for k in template:
        if k not in state and _DERIVED.search(k):
            state[k] = template[k].detach().cpu()
    missing = [k for k in template if k not in state]
    if missing:
        raise ValueError(f"the checkpoint lacks {missing[0]!r} ({len(missing)} keys missing)")
    unexpected = [k for k in state if k not in template]
    if unexpected:
        raise ValueError(f"the checkpoint has {unexpected[0]!r}, which "
                         f"{type(model).__name__} does not ({len(unexpected)} unexpected keys)")
    for k, want in template.items():
        got = state[k]
        if tuple(got.shape) != tuple(want.shape):
            raise ValueError(f"{k!r}: the checkpoint's shape {tuple(got.shape)} differs from "
                             f"the model's {tuple(want.shape)}")
        if got.dtype != want.dtype:
            raise ValueError(f"{k!r}: the checkpoint's dtype {got.dtype} differs from the "
                             f"model's {want.dtype}")
    return state


def load_weights(model: torch.nn.Module, state: Mapping) -> torch.nn.Module:
    """Load a ``transformers`` state dict into the port's SAM or GroundingDINO
    (strict, re-tied); returns ``model``."""
    model.load_state_dict(port_state_dict(model, state))
    if hasattr(model, "tie_weights"):
        model.tie_weights()
    return model


# ------------------------------------------------------------------ local hub

def hub_cache_dir() -> Path:
    if os.environ.get("HF_HUB_CACHE"):
        return Path(os.environ["HF_HUB_CACHE"])
    if os.environ.get("HF_HOME"):
        return Path(os.environ["HF_HOME"]) / "hub"
    return Path.home() / ".cache" / "huggingface" / "hub"


def snapshot_dir(name: str, files=("config.json", "model.safetensors")) -> Path:
    """The local snapshot of hub model ``name`` ("ORG/NAME") that ``refs/main``
    points to, holding ``files``; raises ``FileNotFoundError`` naming the
    first path that is missing."""
    org, _, model = name.partition("/")
    if not org or not model:
        raise ValueError(f"a hub name is 'ORG/NAME', got {name!r}")
    root = hub_cache_dir() / f"models--{org}--{model}"
    ref = root / "refs" / "main"
    if not ref.is_file():
        raise FileNotFoundError(f"no local snapshot of {name}: {ref} is missing (the port "
                                "reads the Hugging Face cache and downloads nothing)")
    snap = root / "snapshots" / ref.read_text().strip()
    for f in files:
        if not (snap / f).is_file():
            raise FileNotFoundError(f"the local snapshot of {name} lacks {snap / f}")
    return snap


def _read_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def sam_from_snapshot(snap: Path):
    """(config, state dict) of a SAM snapshot directory."""
    return (SamConfig.from_dict(_read_json(snap / "config.json")),
            read_safetensors(str(snap / "model.safetensors")))


def gdino_from_snapshot(snap: Path):
    """(config, state dict, vocab path) of a GroundingDINO snapshot directory;
    the processor's size comes from ``preprocessor_config.json`` where the
    snapshot has one, else the published 800/1333."""
    config = _read_json(snap / "config.json")
    size = {"shortest_edge": 800, "longest_edge": 1333}
    pre = snap / "preprocessor_config.json"
    if pre.is_file():
        size = dict(_read_json(pre).get("size", size))
    config["processor_size"] = size
    return (GroundingDinoConfig.from_dict(config),
            read_safetensors(str(snap / "model.safetensors")), snap / "vocab.txt")
