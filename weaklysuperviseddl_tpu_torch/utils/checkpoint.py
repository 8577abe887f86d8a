"""Checkpoints and resume (port of weaklysuperviseddl_tpu/utils/checkpoint.py).

The reference saves weights only (``torch.save(state_dict)``), with no
optimizer state, step count or resume. Here:

  * ``save_state``/``restore_state`` keep a whole training state (the
    model's ``state_dict`` with its BatchNorm statistics, the optimizer's
    moments and its device counters as 0-dim tensors, ``step``) in one
    ``torch.save`` file, read back with ``torch.load(weights_only=True)`` and
    checked against a template (files with the counters as ints, written
    before they moved to the device, still load);
  * ``save_alternation``/``restore_alternation`` keep the alternating loop's
    state per alternation: ``alt_NNN/state.pt`` and the mask store as
    ``alt_NNN/masks.npz`` (``MaskStore.save_arrays``), written into
    ``alt_NNN.tmp`` and renamed once both are on disk.

On a mesh (``SegTrainState.mesh``), a snapshot has the one-device layout:
every rank makes the sharded weights and their Adam moments whole (a
collective), rank 0 writes, and the others wait at a barrier;
``restore_alternation`` reads the whole state on every rank and cuts it to
the rank's layout. The JAX package writes orbax directories and PNG mask
directories; neither package reads the other's snapshots.
"""

from __future__ import annotations

import os
import shutil

import torch
import torch.distributed as dist

from weaklysuperviseddl_tpu_torch.data.mask_store import MaskStore
from weaklysuperviseddl_tpu_torch.parallel.mesh import (
    full_state_dict,
    is_main_rank,
    local_state_dict,
    tp_parameters,
)

STATE_FILE = "state.pt"
MASKS_FILE = "masks.npz"


def _fsync_dir(path: str):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save_state(path: str, state_tree) -> None:
    """Save a tree of dicts, lists, tensors and ints to ``path``, synced to
    disk before it returns."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        torch.save(state_tree, f)
        f.flush()
        os.fsync(f.fileno())


def _structure(tree):
    """The tree's keys, list lengths and tensor shapes and dtypes. A counter
    is "int" whether it is a Python int or a 0-dim integer tensor: the
    optimizer's counters are device tensors, and snapshots written before
    they were hold ints."""
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_structure(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        if tree.ndim == 0 and not tree.is_floating_point() and tree.dtype != torch.bool:
            return "int"
        return (tuple(tree.shape), tree.dtype)
    return type(tree).__name__


def _first_difference(want, got, path="") -> str:
    if isinstance(want, dict) and isinstance(got, dict):
        if want.keys() != got.keys():
            missing = sorted(set(want) - set(got))[:3]
            extra = sorted(set(got) - set(want))[:3]
            return f"{path or '/'}: keys missing {missing}, unexpected {extra}"
        for k in want:
            if want[k] != got[k]:
                return _first_difference(want[k], got[k], f"{path}/{k}")
    if isinstance(want, list) and isinstance(got, list) and len(want) == len(got):
        for i, (a, b) in enumerate(zip(want, got)):
            if a != b:
                return _first_difference(a, b, f"{path}/{i}")
    return f"{path or '/'}: saved {got}, expected {want}"


def restore_state(path: str, template_tree):
    """Read a tree written by ``save_state`` (tensors on the CPU). Raises
    ``ValueError`` when its keys, list lengths or tensor shapes and dtypes
    differ from ``template_tree``'s: a state saved under another model or
    optimizer config."""
    tree = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    want, got = _structure(template_tree), _structure(tree)
    if want != got:
        raise ValueError(
            f"checkpoint at {path} has another structure than the current config expects "
            f"({_first_difference(want, got)}); resume with the model and optimizer config "
            "it was saved under")
    return tree


def _moments(state, tree: dict, cut) -> dict:
    """The optimizer's state with each moment of a sharded weight passed
    through ``cut(tp, tensor)``."""
    tp = tp_parameters(state.model)
    if not tp:
        return tree
    names = [n for n, _ in state.model.named_parameters()]
    return {**tree, **{key: [cut(tp[n], t) if n in tp else t for n, t in zip(names, tree[key])]
                       for key in ("m", "v")}}


def seg_state_tree(state) -> dict:
    """``SegTrainState`` → a tree for ``save_state``: the model's state dict
    (parameters and BatchNorm statistics), the optimizer's state, ``step``,
    in the one-device layout (on a mesh with a model axis every rank calls
    it: the sharded tensors are gathered)."""
    return {"model": full_state_dict(state.model),
            "optimizer": _moments(state, state.optimizer.state_dict(), lambda tp, t: tp.full(t)),
            "step": int(state.step)}


def load_seg_state(state, tree):
    """Copy a ``seg_state_tree`` into ``state``'s model (in place: the
    optimizer keeps the same parameter objects) and then its optimizer, each
    cut to the model's layout."""
    state.model.load_state_dict(local_state_dict(state.model, tree["model"]), strict=True)
    state.optimizer.load_state_dict(_moments(state, tree["optimizer"],
                                             lambda tp, t: tp.local(t)))
    state.step = int(tree["step"])
    return state


def load_model_weights(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load the model part of a seg state file (``save_state`` of a
    ``seg_state_tree``, or a snapshot's ``state.pt``) into ``model``. Raises
    ``ValueError`` when the file holds no seg state or its weights do not fit
    ``model``."""
    tree = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    if not isinstance(tree, dict) or not isinstance(tree.get("model"), dict):
        raise ValueError(f"{path} holds no seg state (a dict with a 'model' state dict), "
                         "as utils/checkpoint.save_state of seg_state_tree writes")
    want = _structure(dict(model.state_dict()))
    got = _structure(tree["model"])
    if want != got:
        raise ValueError(f"the weights in {path} do not fit {type(model).__name__} "
                         f"({_first_difference(want, got)}): it was saved from a model of "
                         "another depth, width or class count")
    model.load_state_dict(tree["model"], strict=True)
    return model


def _alternation_dirs(root: str) -> dict[int, str]:
    """Alternation index → snapshot directory name, for every snapshot under
    ``root`` that holds both its state and its masks. Of ``alt_7`` and
    ``alt_007`` the zero-padded name wins."""
    found: dict[int, str] = {}
    if not os.path.isdir(root):
        return found
    for name in os.listdir(root):
        if not name.startswith("alt_"):
            continue
        try:
            i = int(name[4:])
        except ValueError:
            continue
        alt_dir = os.path.join(root, name)
        ok = (os.path.isfile(os.path.join(alt_dir, STATE_FILE))
              and os.path.isfile(os.path.join(alt_dir, MASKS_FILE)))
        if ok and (i not in found or len(name) > len(found[i])):
            found[i] = name
    return found


def latest_alternation(root: str) -> int | None:
    """The highest alternation index with a snapshot under ``root``, or None."""
    found = _alternation_dirs(root)
    return max(found) if found else None


def restore_alternation(root: str, state, iteration: int | None = None):
    """Restore the snapshot of ``iteration`` (default: the latest) into
    ``state`` and a new in-memory ``MaskStore``. Returns ``(state, store,
    next_iteration)``: pass ``next_iteration`` to
    ``run_alternating_training(start_iteration=...)``."""
    found = _alternation_dirs(root)
    if iteration is None:
        if not found:
            raise FileNotFoundError(f"no alternation snapshots under {root}")
        iteration = max(found)
    alt_dir = os.path.join(os.path.abspath(root), found.get(iteration, f"alt_{iteration:03d}"))
    tree = restore_state(os.path.join(alt_dir, STATE_FILE), seg_state_tree(state))
    state = load_seg_state(state, tree)
    store = MaskStore.load_arrays(os.path.join(alt_dir, MASKS_FILE))
    return state, store, iteration + 1


def save_alternation(root: str, iteration: int, state, store: MaskStore) -> str:
    """Snapshot the train state and the mask store after ``iteration``.

    Crash-atomic: both files go into ``alt_NNN.tmp`` (a leftover one is
    removed first), are synced to disk, and the directory is renamed to
    ``alt_NNN`` (replacing an earlier snapshot of the same iteration), so a
    run killed mid-checkpoint never leaves a snapshot ``latest_alternation``
    takes for a whole one."""
    root = os.path.abspath(root)
    alt_dir = os.path.join(root, f"alt_{iteration:03d}")
    tree = seg_state_tree(state)
    if is_main_rank():
        tmp_dir = alt_dir + ".tmp"
        if os.path.exists(tmp_dir):
            shutil.rmtree(tmp_dir)
        os.makedirs(tmp_dir)
        save_state(os.path.join(tmp_dir, STATE_FILE), tree)
        store.save_arrays(os.path.join(tmp_dir, MASKS_FILE))
        _fsync_dir(tmp_dir)
        if os.path.exists(alt_dir):
            shutil.rmtree(alt_dir)
        os.rename(tmp_dir, alt_dir)
        _fsync_dir(root)
    if state.mesh is not None and state.mesh.distributed:
        dist.barrier()
    return alt_dir
