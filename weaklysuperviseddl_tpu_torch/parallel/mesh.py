"""The ('data', 'model') mesh (port of weaklysuperviseddl_tpu/parallel/mesh.py),
in ``torch.distributed``'s idiom: one process per device.

JAX compiles one program over a device mesh and GSPMD inserts the
collectives. Here every rank runs the same program and the collectives are
written out (``parallel/collectives.py``):

  * an array JAX shards on 'data' is split by rank (``shard_batch``); one
    that JAX leaves unsharded is the same on every rank. Where a stage's
    result can differ from run to run on the card (anything through cuDNN's
    backward), rank 0 computes it and ``replicate_tree`` broadcasts it;
  * the axes are the subgroups of a named 2-D ``DeviceMesh``, its ranks laid
    out row-major as JAX's devices are (``reshape(devices, (data, model))``);
  * tensor parallelism (``shard_params_tp``): a conv or linear layer whose
    weight ``tp_leaf_sharding`` shards keeps its slice of the output
    channels, computes them and gathers them within its 'model' group.

A mesh built outside a process group is a *local* mesh over this process's
devices. Only ``Predictor(mesh=)`` serves on one of several devices (JAX's
mesh serving is one process too); the training functions refuse it.

Process groups: ``init_distributed`` brings one up, from torchrun's
environment or for ``Ranks``, which starts the ranks itself and meets them
through a ``file://`` store in a temporary directory (a TCP port would clash
between concurrent runs on one host). The backend is NCCL on the card and
gloo on the CPU, never one for the other. A mesh larger than the visible
cards raises, as JAX's does; it never runs on fewer.
"""

from __future__ import annotations

import datetime
import os
import pickle
import queue
import shutil
import tempfile
import traceback
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from weaklysuperviseddl_tpu_torch.device import resolve_device
from weaklysuperviseddl_tpu_torch.parallel.collectives import TensorParallel

AXES = ("data", "model")
# rank 0 runs the unsharded stages (classifier, CAMs, pseudo-masks) while the
# other ranks wait in a broadcast: a full-scale stage outlasts the default
TIMEOUT = datetime.timedelta(hours=2)
RANKS_HINT = ("launch one process per device: python -m weaklysuperviseddl_tpu_torch "
              "weakly --mesh.data N starts its ranks itself, or run it under torchrun "
              "--nproc-per-node N")


@dataclass(frozen=True, eq=False)
class Mesh:
    """A ('data', 'model') mesh. ``devices``: a local mesh's devices, row
    major; a distributed mesh's device of this rank. ``device_mesh``: the
    ``DeviceMesh`` of a distributed mesh, None for a local one."""

    data: int
    model: int
    devices: tuple
    device_mesh: Any = None

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.data, "model": self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def distributed(self) -> bool:
        return self.device_mesh is not None

    @property
    def device(self) -> torch.device:
        """This rank's device (a local mesh's first)."""
        return self.devices[0]

    @property
    def data_devices(self) -> tuple:
        """A local mesh's device at each index of the data axis."""
        return self.devices[::self.model]

    def group(self, axis: str | None = None):
        """The process group of this rank's ``axis`` ('data', 'model'), or of
        the whole mesh."""
        if axis is None:
            return dist.group.WORLD
        return self.device_mesh.get_group(axis)

    def index(self, axis: str) -> int:
        """This rank's index on ``axis``."""
        if not self.distributed:
            return 0
        return self.device_mesh.get_coordinate()[AXES.index(axis)]

    def require_distributed(self, what: str):
        """Raise unless this mesh has process groups or only one device."""
        if not self.distributed and self.size > 1:
            raise ValueError(f"{what} needs a process group for a mesh of {self.size} devices; "
                             + RANKS_HINT)


def visible_cards() -> list[torch.device]:
    """Every card this process sees; raises without one
    (``device.resolve_device``)."""
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def this_device() -> torch.device:
    """The device of this rank of the process group."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh(data: int = -1, model: int = 1, devices=None) -> Mesh:
    """A ('data', 'model') mesh; data=-1 → every remaining device. Inside a
    process group (``devices`` None) the mesh is over its ranks; else it is
    local, over ``devices`` (default: the visible cards). The shape rules
    and messages are JAX's."""
    distributed = devices is None and dist.is_initialized()
    if devices is None and not distributed:
        devices = visible_cards()
    n = dist.get_world_size() if distributed else len(devices)
    if data == -1:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    if not distributed:
        return Mesh(data, model, tuple(torch.device(d) for d in devices))
    from torch.distributed.device_mesh import init_device_mesh

    device = this_device()
    device_mesh = init_device_mesh(device.type, (data, model), mesh_dim_names=AXES)
    return Mesh(data, model, (device,), device_mesh)


def mesh_from_config(mesh_cfg, device=None) -> Mesh | None:
    """The mesh of a ``config.MeshConfig``: None on one device with no model
    axis and data ∈ {-1, 1} (the one-device path stays sharding-free), else
    ``make_mesh`` over the process group's ranks or, outside one, over the
    visible cards (the CPU: one device). A mesh larger than that raises."""
    if dist.is_initialized():
        n = dist.get_world_size()
        devices = None
    else:
        devices = (visible_cards() if resolve_device(device).type == "cuda"
                   else [torch.device("cpu")])
        n = len(devices)
    if n == 1 and mesh_cfg.model == 1 and mesh_cfg.data in (-1, 1):
        return None
    return make_mesh(data=mesh_cfg.data, model=mesh_cfg.model, devices=devices)


def batch_sharding(mesh: Mesh, batch: int) -> slice:
    """This rank's rows of a batch of ``batch`` split on the 'data' axis."""
    if batch % mesh.data:
        raise ValueError(f"batch {batch} not divisible by data axis {mesh.data}")
    share = batch // mesh.data
    d = mesh.index("data")
    return slice(d * share, (d + 1) * share)


def shard_batch(mesh: Mesh, *arrays):
    """Each [B,...] array's rows of this rank on the 'data' axis, as tensors
    on its device."""
    mesh.require_distributed("shard_batch")
    out = tuple(torch.as_tensor(a)[batch_sharding(mesh, a.shape[0])].to(mesh.device)
                for a in arrays)
    return out if len(out) > 1 else out[0]


@dataclass(frozen=True)
class _Leaf:
    numpy: bool
    shape: tuple
    dtype: Any


def replicated(mesh: Mesh, x):
    """Rank 0's ``x`` (a tensor or a numpy array; anything on the others)
    on every rank of ``mesh``: one broadcast."""
    return replicate_tree(mesh, x)


def replicate_tree(mesh: Mesh, tree):
    """Rank 0's tree (dicts, lists and tuples of tensors, numpy arrays and
    picklable values) on every rank: the other ranks may pass anything. The
    structure and the small values go as one object broadcast, then each
    array as a broadcast on this rank's device; arrays come back as the kind
    they were on rank 0, tensors on this rank's device."""
    if not mesh.distributed:
        return tree
    leaves: list = []

    def skeleton(t):
        if isinstance(t, (torch.Tensor, np.ndarray)):
            leaves.append(torch.as_tensor(t))
            return _Leaf(isinstance(t, np.ndarray), tuple(t.shape), leaves[-1].dtype)
        if isinstance(t, dict):
            return {k: skeleton(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(skeleton(v) for v in t)
        return t

    box = [skeleton(tree) if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(box, src=0, device=mesh.device)
    it = iter(leaves)

    def fill(s):
        if isinstance(s, _Leaf):
            t = (next(it).to(mesh.device).contiguous() if dist.get_rank() == 0
                 else torch.empty(s.shape, dtype=s.dtype, device=mesh.device))
            dist.broadcast(t, src=0)
            return t.cpu().numpy() if s.numpy else t
        if isinstance(s, dict):
            return {k: fill(v) for k, v in s.items()}
        if isinstance(s, (list, tuple)):
            return type(s)(fill(v) for v in s)
        return s

    return fill(box[0])


def tp_leaf_sharding(mesh: Mesh, x: torch.Tensor, min_channels: int = 64) -> int | None:
    """JAX's tensor-parallel rule for one parameter: the dim the 'model' axis
    shards, or None (replicated). JAX shards a flax kernel's last axis, its
    output channels ([kh,kw,I,O], [I,O]) where the axis divides them and
    there are at least ``min_channels``; in a torch weight ([O,I,kh,kw],
    [O,I]) that axis is dim 0. Biases, BatchNorm's vectors and small
    kernels stay replicated."""
    m = mesh.model
    if m == 1 or x.ndim < 2:
        return None
    return 0 if x.shape[0] % m == 0 and x.shape[0] >= min_channels else None


def shard_params_tp(mesh: Mesh, model: torch.nn.Module, min_channels: int = 64):
    """JAX's TP layout of ``model`` in place: every convolution whose weight
    ``tp_leaf_sharding`` shards keeps this rank's slice of its output
    channels and gathers the channels after computing them
    (``TensorParallel``, ``models/resnet.Conv2d``); the rest is replicated.
    Another layer with such a weight raises TypeError (DeepLabV3, the model
    that trains on a mesh, has none). Build the optimizer after: the sharded
    weights are new parameters. Returns the model."""
    from weaklysuperviseddl_tpu_torch.models.resnet import Conv2d

    if mesh.model == 1:
        return model
    mesh.require_distributed("tensor parallelism")
    for name, m in model.named_modules():
        weight = getattr(m, "weight", None)
        if not isinstance(weight, torch.Tensor) or tp_leaf_sharding(mesh, weight,
                                                                    min_channels) is None:
            continue
        if not isinstance(m, Conv2d):
            raise TypeError(f"{name} ({type(m).__name__}) has a weight that the model axis "
                            "shards but no tensor-parallel forward")
        tp = TensorParallel(mesh.group("model"), mesh.index("model"), mesh.model,
                            m.weight.shape[0])
        m.weight = torch.nn.Parameter(tp.local(m.weight.detach()).clone(),
                                      requires_grad=m.weight.requires_grad)
        m.tp = tp
    return model


def tp_parameters(model: torch.nn.Module) -> dict[str, TensorParallel]:
    """Parameter name → its ``TensorParallel``, for the sharded weights."""
    return {(f"{name}." if name else "") + "weight": m.tp
            for name, m in model.named_modules() if getattr(m, "tp", None) is not None}


def full_state_dict(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """``model.state_dict()`` with every sharded weight made whole: the
    one-device layout (a collective: every rank of the model axis calls it)."""
    tp = tp_parameters(model)
    return {k: tp[k].full(v) if k in tp else v for k, v in model.state_dict().items()}


def local_state_dict(model: torch.nn.Module, full: dict) -> dict:
    """A whole state dict cut to ``model``'s layout: this rank's rows of each
    sharded weight."""
    tp = tp_parameters(model)
    return {k: tp[k].local(v) if k in tp else v for k, v in full.items()}


def under_torchrun() -> bool:
    """Whether torchrun (or another launcher of its environment) started
    this process as one rank."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def is_main_rank() -> bool:
    """Rank 0 of the process group, or a process outside one."""
    return not dist.is_initialized() or dist.get_rank() == 0


def init_distributed(device_type: str, rank: int | None = None, world_size: int | None = None,
                     init_method: str = "env://"):
    """Join the process group: NCCL on the card (this rank's card is
    ``LOCAL_RANK``, else ``rank``), gloo on the CPU. ``rank`` and
    ``world_size`` None: torchrun's environment."""
    if device_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank if rank is not None else 0))
        if local >= torch.cuda.device_count():
            raise ValueError(f"rank {local} has no card: {torch.cuda.device_count()} visible")
        torch.cuda.set_device(local)
        backend = "nccl"
    elif device_type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"unknown device type {device_type!r}; expected 'cuda' or 'cpu'")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, timeout=TIMEOUT)


def _rank_main(rank, nprocs, device_type, init_method, call_file, results):
    # every rank of a spawned group is on this host: the transports stay on
    # the loopback interface
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    if device_type == "cpu":
        os.environ["OMP_NUM_THREADS"] = "1"
        torch.set_num_threads(1)
    try:
        with open(call_file, "rb") as f:
            fn, args = pickle.load(f)  # written by Ranks in this program
        init_distributed(device_type, rank, nprocs, init_method)
        results.put((rank, True, fn(*args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class Ranks:
    """``nprocs`` processes (spawned), each joining one process group as a
    rank and running ``fn(*args)``; ``fn`` is pickled by its import path and
    its result is sent back. Started on construction; ``join`` waits and
    returns the results in rank order. On the card rank r takes card r.
    When a rank fails the others are stopped and ``join`` raises with its
    traceback. The call goes to the ranks in a file: a start blocks until
    its process has read what it is given, which it does only once it has
    imported its modules, so large arguments in the start would start the
    ranks one after another."""

    def __init__(self, fn, nprocs: int, device_type: str, *args):
        import torch.multiprocessing as mp

        if device_type == "cuda" and nprocs > torch.cuda.device_count():
            raise ValueError(f"mesh of {nprocs} ranks on {torch.cuda.device_count()} cards")
        ctx = mp.get_context("spawn")
        self._dir = tempfile.mkdtemp(prefix="wsdl_ranks_")
        init = f"file://{os.path.join(self._dir, 'store')}"
        call_file = os.path.join(self._dir, "call.pkl")
        with open(call_file, "wb") as f:
            pickle.dump((fn, args), f)
        self._results = ctx.Queue()
        self._procs = [ctx.Process(target=_rank_main, args=(r, nprocs, device_type, init,
                                                             call_file, self._results))
                       for r in range(nprocs)]
        for p in self._procs:
            p.start()

    def join(self) -> list:
        got: dict[int, Any] = {}
        failure = None
        while failure is None and len(got) < len(self._procs):
            try:
                rank, ok, value = self._results.get(timeout=1.0)
            except queue.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(self._procs)
                        if p.exitcode not in (None, 0)]
                if dead:
                    failure = f"rank {dead[0][0]} exited with code {dead[0][1]}"
                continue
            if ok:
                got[rank] = value
            else:
                failure = f"rank {rank} failed:\n{value}"
        try:
            if failure is not None:
                for p in self._procs:
                    p.terminate()
                raise RuntimeError(failure)
        finally:
            for p in self._procs:
                p.join()
            shutil.rmtree(self._dir, ignore_errors=True)
        return [got[r] for r in range(len(self._procs))]


def spawn(fn, nprocs: int, device_type: str, *args) -> list:
    """``Ranks(fn, nprocs, device_type, *args).join()``."""
    return Ranks(fn, nprocs, device_type, *args).join()
