"""DeepLabV3 segmentation training (port of weaklysuperviseddl_tpu/train/segmentation.py;
ref TraditionalModel/SegmentationModel.py:59-159).

Adam (lr 1e-4) over all parameters behind the non-finite-gradient guard, CE
(or, with ``loss_fn="lovasz_softmax"``, the per-image Lovász-Softmax over the
present classes of the softmax) on pseudo-masks clamped to {0,1}, BatchNorm in training mode (batch
statistics, flax's running-statistics update: ``models/resnet.BatchNorm2d``).
Batches are fixed-shape: the ragged tail repeats its last index and those
rows carry weight 0 in the loss, as in the JAX package (they still enter the
batch statistics, as they do there). The dataset is uploaded once and each
batch is a gather on the device: uint8 → preprocess → ImageNet
normalisation, masks nearest-resized (half-pixel centres) to ``seg_size``.
A bfloat16 DeepLabV3 (``seg.dtype``) trains the same way: its parameters, its
gradients and Adam's state are float32, its forward and backward run in
bfloat16, and its logits come back float32, so the losses, the predictions
and the evaluators are float32.

The ASPP's dropout is keyed before every step from (seed + 1, epoch, step)
through ``dropout_seed``, a fixed integer mix, so ``seed`` alone fixes a run
in any process, as the JAX package's keys (``PRNGKey(seed + 1)``, split per
epoch, folded with the step) do; the bits differ from JAX's threefry.
``train_segmentation_model`` runs its steps in chunks of ``steps_per_dispatch``
as JAX's epoch programs do, each chunk one replay of a CUDA graph on the card.

On a ('data', 'model') mesh (``parallel/mesh.py``), as JAX lays it out:
``create_seg_state(mesh=)`` shards the conv output channels on 'model'
(``shard_params_tp``; Adam's moments follow the weights) and the guard
decides over the whole mesh; ``train_segmentation_model(mesh=)`` splits the
dataset over 'data' (wrap-around padding to D·n_local rows, [D, n_local]
per-shard permutations each epoch, a ragged per-shard tail repeating its last
index with weight 0), and each step is the one-device step on the global
batch (``seg_train_step(mesh=)``); ``evaluate_segmentation_sharded`` sums the
ranks' confusion counters with one all-reduce.

Evaluation (``evaluate_segmentation_dataset``, and ``evaluate_segmentation``
over a loader) is the reference's ``evaluate_model``: predict at
``seg_size``, nearest-resize the trimaps to ``eval_size`` and the predictions
(legacy nearest) to the trimaps' size, binarise the truth ("fg1": trimap ==
1; "shifted_inverted": 1 − clip(t − 1, 0, 1), CutLoss.py:658-662), mean of
per-image IoU and accuracy. The supervised baseline's
(``evaluate_multiclass_dataset``, and ``evaluate_multiclass`` over a loader,
ref SupervisedModel.py:44-83): per batch the nanmean of per-class IoU and the
pixel accuracy against trimap == 1, averaged over batches, padded rows out of
every counter.
"""

from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from weaklysuperviseddl_tpu_torch.data.preprocess import normalize_images as _normalize_images
from weaklysuperviseddl_tpu_torch.data.preprocess import preprocess_batch
from weaklysuperviseddl_tpu_torch.losses.basic import per_example_nll
from weaklysuperviseddl_tpu_torch.losses.lovasz import lovasz_softmax_per_image
from weaklysuperviseddl_tpu_torch.models.deeplabv3 import Dropout, seed_dropout
from weaklysuperviseddl_tpu_torch.models.resnet import BatchNorm2d, init_weights
from weaklysuperviseddl_tpu_torch.ops.resize import resize_nearest
from weaklysuperviseddl_tpu_torch.parallel.collectives import all_reduce_value
from weaklysuperviseddl_tpu_torch.parallel.mesh import shard_batch, shard_params_tp
from weaklysuperviseddl_tpu_torch.train.guard import GuardedAdam
from weaklysuperviseddl_tpu_torch.utils.cache import BoundedCache
from weaklysuperviseddl_tpu_torch.utils.graphs import Captured, capture, warm_up
from weaklysuperviseddl_tpu_torch.utils.metrics import (
    binary_confusion_counts,
    compute_iou_and_acc,
    finish_iou_and_acc,
    per_class_iou,
)
from weaklysuperviseddl_tpu_torch.utils.profiling import span


LOSSES = ("cross_entropy", "lovasz_softmax")
BINARIZE = ("fg1", "shifted_inverted")
_M64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def dropout_seed(seed: int, epoch: int, step: int) -> int:
    """The dropout generator's seed for one training step: splitmix64 rounds
    over (seed, epoch, step), a pure function of the three in any process."""
    h = 0
    for v in (seed, epoch, step):
        h = _splitmix64(h ^ (v & _M64))
    return h


@dataclass
class SegTrainState:
    """The model (parameters and BatchNorm statistics) and its optimizer;
    ``mesh``: the mesh ``create_seg_state`` laid them out on, or None."""

    model: torch.nn.Module
    optimizer: GuardedAdam
    step: int = 0
    mesh: Any = None


def create_seg_state(model: torch.nn.Module, seed: int, lr: float = 1e-4,
                     device=None, mesh=None) -> SegTrainState:
    """Seeded random weights (``init_weights``) on ``device`` and Adam behind
    the non-finite-gradient guard. ``mesh`` (a ``parallel/mesh.Mesh`` with
    process groups): the weights on this rank's device in JAX's tensor-
    parallel layout, and the guard's decision taken over the whole mesh."""
    init_weights(model, torch.Generator().manual_seed(seed))
    group = None
    if mesh is not None:
        mesh.require_distributed("create_seg_state")
        device = mesh.device
        group = mesh.group() if mesh.size > 1 else None
    if device is not None:
        model.to(device)
    if mesh is not None:
        shard_params_tp(mesh, model)
    return SegTrainState(model=model, optimizer=GuardedAdam(model.parameters(), lr=lr,
                                                            group=group), mesh=mesh)


@contextlib.contextmanager
def _batch_shard(model: torch.nn.Module, mesh, group):
    """While a step's forward runs on shard d of D of a global batch: every
    BatchNorm takes statistics over ``group`` and every dropout draws the
    global batch's mask."""
    layers = [m for m in model.modules() if isinstance(m, (BatchNorm2d, Dropout))]
    for m in layers:
        if isinstance(m, BatchNorm2d):
            m.data_group = group
        else:
            m.batch_shard = (mesh.data, mesh.index("data"))
    try:
        yield
    finally:
        for m in layers:
            if isinstance(m, BatchNorm2d):
                m.data_group = None
            else:
                m.batch_shard = None


@torch.no_grad()
def _sum_gradients(params, group):
    """Every parameter's gradient summed over ``group``, in one all-reduce."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    torch.distributed.all_reduce(flat, group=group)
    for p, g in zip(params, flat.split([g.numel() for g in grads])):
        p.grad = g.view_as(p)


def seg_train_step(state: SegTrainState, images: torch.Tensor, masks: torch.Tensor,
                   valid: torch.Tensor, loss_fn: str = "cross_entropy",
                   mesh=None) -> torch.Tensor:
    """One step on normalised [B,H,W,3] images and [B,H,W] integer masks;
    ``valid`` [B] masks padded rows out of the loss. Returns the loss (0-dim,
    on the device).

    ``mesh``: the batch is this rank's shard of a global batch split over
    the mesh's 'data' axis. BatchNorm then takes the global batch's
    statistics, the dropout its rows of the global mask, the loss is
    Σ_global(per-example loss · valid) / max(Σ_global valid, 1) (every rank
    returns it), and the gradients are summed over the axis: the step is the
    one-device step on the global batch."""
    loss = _train_step(state, images, masks, valid, loss_fn, mesh)
    state.step += 1
    return loss


def _train_step(state: SegTrainState, images: torch.Tensor, masks: torch.Tensor,
                valid: torch.Tensor, loss_fn: str, mesh) -> torch.Tensor:
    """``seg_train_step`` without the host's step count: every operation
    runs on the device and nothing is read back, so a CUDA graph can hold
    it."""
    if loss_fn not in LOSSES:
        raise ValueError(f"unknown loss_fn {loss_fn!r}; expected one of {LOSSES}")
    model = state.model
    model.train()
    group = None if mesh is None or mesh.data == 1 else mesh.group("data")
    with _batch_shard(model, mesh, group) if group is not None else contextlib.nullcontext():
        logits = model(images.permute(0, 3, 1, 2))                  # [B,C,H,W]
    masks_c = masks.clamp(0, 1)                                     # ref :100 clamp(max=1)
    if loss_fn == "lovasz_softmax":
        # per image, so that padded rows can be weighted out
        probas = torch.softmax(logits, dim=1).permute(0, 2, 3, 1)
        per = lovasz_softmax_per_image(probas, masks_c, classes="present")
    else:
        per = per_example_nll(logits, masks_c, dim=1).mean(dim=(1, 2))  # [B]
    w = valid.float()
    count = w.sum() if group is None else all_reduce_value(w.sum(), group)
    loss = (per * w).sum() / count.clamp(min=1.0)
    state.optimizer.zero_grad()
    loss.backward()
    if group is not None:
        _sum_gradients(state.optimizer.params, group)
        loss = all_reduce_value(loss, group)
    state.optimizer.step()
    return loss.detach()


def _as_device_tensor(a, device) -> torch.Tensor:
    return a.to(device) if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a)).to(device)


def _prep(raw: torch.Tensor, m: torch.Tensor, seg_size: int):
    x, _ = preprocess_batch(raw, None, size=seg_size)
    x = _normalize_images(x)
    m = m.to(torch.int32)
    if m.shape[1] != seg_size or m.shape[2] != seg_size:
        m = resize_nearest(m, (seg_size, seg_size), torch_legacy=False, axes=(1, 2))
    return x, m


def _epoch_table(order_rows, b: int, seeds) -> np.ndarray:
    """[T, 2b+1] int64 rows [indices b | valid b | dropout seed] of one epoch:
    ``order_rows`` is a list of T index arrays of at most b entries (a short
    one repeats its last index, with valid 0), ``seeds`` the T dropout seeds
    (64-bit patterns, stored as int64)."""
    T = len(order_rows)
    table = np.zeros((T, 2 * b + 1), np.int64)
    for t, idx in enumerate(order_rows):
        nv = len(idx)
        table[t, :nv] = idx
        table[t, nv:b] = idx[-1]
        table[t, b:b + nv] = 1
    table[:, 2 * b] = np.asarray(seeds, np.uint64).view(np.int64)
    return table


def _stage(table: np.ndarray, dev) -> torch.Tensor:
    """One host-to-device copy of an epoch's table (pinned and asynchronous
    on the card, so that the host runs ahead)."""
    t = torch.from_numpy(table)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def _table_step(state: SegTrainState, images, masks, row: torch.Tensor, b: int, seg_size: int,
                loss_fn: str, mesh, acc: torch.Tensor):
    """One training step from a table row [indices b | valid b | seed]:
    gather from the resident dataset, ``_prep``, the dropout keyed by the
    row's seed, ``_train_step``; its loss is added into ``acc``. Every
    operand lives on the device, so the step reads nothing back."""
    idx = row[:b]
    x, m = _prep(images[idx], masks[idx], seg_size)
    seed_dropout(state.model, row[2 * b])
    acc.add_(_train_step(state, x, m, row[b:2 * b] != 0, loss_fn, mesh))


def _state_tensors(state: SegTrainState) -> list[torch.Tensor]:
    """Every tensor a training step reads and writes in place: parameters,
    buffers (BatchNorm statistics, the dropout key), Adam's moments and its
    counters."""
    opt = state.optimizer
    return [*state.model.parameters(), *state.model.buffers(), *opt.m, *opt.v, opt.count,
            opt.notfinite_count, opt.total_notfinite]


def _addresses(tensors) -> tuple:
    return tuple((t.data_ptr(), t.dtype, tuple(t.shape), t.stride()) for t in tensors)


class _EagerEpochs:
    """The chunk's steps in order, op by op: the CPU, and a mesh of more than
    one rank (collectives inside a captured graph would need NCCL's graph
    support, which one card cannot check)."""

    def __init__(self, b, seg_size, loss_fn, mesh, device):
        self.b, self.seg_size, self.loss_fn, self.mesh = b, seg_size, loss_fn, mesh
        self.acc = torch.zeros((), device=device)

    def run(self, rows: torch.Tensor, state, images, masks):
        for row in rows:
            _table_step(state, images, masks, row, self.b, self.seg_size, self.loss_fn,
                        self.mesh, self.acc)


class _GraphEpochs:
    """The card's epoch programs: a CUDA graph of K steps (JAX's
    ``chunk_step``) and one of a single step (``single_step``, for the
    ragged tail and a partly valid step), each replayed from a static table
    that a device-to-device copy refills. Both gather from the resident
    dataset they were captured on (its addresses are part of ``fits``: the
    alternations pass the same tensors and replay) and add their losses into
    one accumulator. Captured at first use, after one warm-up step on a side
    stream whose effects are undone; they hold no reference to the state or
    the dataset (only weak ones to the state), so the cache entry dies with
    its optimizer."""

    def __init__(self, state, images, masks, b, seg_size, loss_fn, K):
        self.b, self.seg_size, self.loss_fn = b, seg_size, loss_fn
        dev = images.device
        self.acc = torch.zeros((), device=dev)
        self.tables = {k: torch.zeros((k, 2 * b + 1), dtype=torch.int64, device=dev)
                       for k in {1, K}}
        self.graphs: dict[int, Captured] = {}
        self.stream = torch.cuda.Stream(dev)
        self.warm = False
        self.model = weakref.ref(state.model)
        self.optimizer = weakref.ref(state.optimizer)
        self.fingerprint = self._fingerprint(state, images, masks)

    @staticmethod
    def _fingerprint(state, images, masks) -> tuple:
        return _addresses([*_state_tensors(state), images, masks])

    def fits(self, state, images, masks) -> bool:
        """Whether the graphs were captured on this state's tensors and this
        dataset, at the addresses they have now."""
        return (self.model() is state.model and self.optimizer() is state.optimizer
                and self.fingerprint == self._fingerprint(state, images, masks))

    def _step(self, state, images, masks, row):
        _table_step(state, images, masks, row, self.b, self.seg_size, self.loss_fn, None,
                    self.acc)

    def _capture(self, k: int, state, images, masks):
        table = self.tables[k]
        if not self.warm:
            def one_step():
                self._step(state, images, masks, table[0])
                state.optimizer.zero_grad()

            warm_up(one_step, self.stream, [*_state_tensors(state), self.acc])
            self.warm = True
        state.optimizer.zero_grad()       # the gradients come from the graph's pool
        self.graphs[k] = capture(
            lambda: [self._step(state, images, masks, table[i]) for i in range(k)], self.stream,
            f"train/chunk{k}")
        state.optimizer.zero_grad()       # ... and stay there, out of the state

    def run(self, rows: torch.Tensor, state, images, masks):
        k = rows.shape[0]
        with span("train/chunk", steps=k):
            self.tables[k].copy_(rows)
            if k not in self.graphs:
                self._capture(k, state, images, masks)
            self.graphs[k].replay()

    @property
    def capture_seconds(self) -> dict:
        return {k: g.capture_seconds for k, g in self.graphs.items()}


# Epoch programs memoised across train_segmentation_model calls, as JAX's
# _EPOCH_PROGRAMS: an alternating run captures its graphs once and replays them
# in every alternation. Keyed on the state's model and optimizer (by identity:
# a graph writes their tensors), the loss, seg_size, the batch, K, the learning
# rate and the math flags that pick cuDNN's and cuBLAS's kernels; an entry whose
# state tensors or dataset moved (another dataset, or another upload of it) is
# captured again.
# LRU-bounded, and each entry is dropped when its optimizer is collected, so
# graphs and their memory pools cannot pile up.
_EPOCH_PROGRAMS = BoundedCache(maxsize=16)


def _math_flags() -> tuple:
    return (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)


def _epoch_programs(state, images, masks, b, seg_size, loss_fn, K) -> _GraphEpochs:
    """The cached ``_GraphEpochs`` of this state and configuration, made anew
    where there is none, or its state tensors or dataset are not those it
    was captured on."""
    key = (id(state.model), id(state.optimizer), loss_fn, seg_size, b, K,
           state.optimizer.lr, _math_flags())
    prog = _EPOCH_PROGRAMS.get(key)
    if prog is None or not prog.fits(state, images, masks):
        prog = _GraphEpochs(state, images, masks, b, seg_size, loss_fn, K)
        _EPOCH_PROGRAMS.put(key, prog)
        weakref.finalize(state.optimizer, _EPOCH_PROGRAMS.discard, key)
    return prog


def train_segmentation_model(state: SegTrainState, images, masks,
                             loss_fn: str = "cross_entropy", num_epochs: int = 10,
                             batch_size: int = 4, seg_size: int = 256, seed: int = 0,
                             run_id: str = "default", eval_fn=None, mesh=None,
                             steps_per_dispatch: int = 8, log=print):
    """Epoch loop over an in-memory pseudo-mask dataset (images [N,H,W,3]
    uint8, masks [N,H,W] {0,1}; numpy or tensors). The per-epoch order is
    ``np.random.default_rng(seed).permutation`` as in the JAX package, and the
    dropout of step t of epoch e is keyed by ``dropout_seed(seed + 1, e, t)``.
    The printout follows SegmentationModel.py:116-120. Returns (state, the last
    epoch's summed loss).

    The dataset is uploaded once and every batch is a gather on the device by
    indices. Each epoch's [T, 2B+1] table (indices, valid rows, dropout
    seeds) goes to the device in one copy, and the summed loss is a device
    scalar read back once an epoch.

    ``steps_per_dispatch`` (K, JAX's default 8): on the card, full chunks of
    K steps run as one replay of a captured CUDA graph, and the ragged tail,
    a partly valid step among it, as replays of a one-step graph; a chunk
    reads nothing back (the guard decides on the device) and launches
    nothing from the host but the replay. The graphs are captured at first
    use and kept for the state (``_EPOCH_PROGRAMS``). A capture or replay
    that fails raises; a capture fails while the caller holds an autograd
    graph over the parameters (say a clone made with gradients on), since
    autograd then accumulates their gradients on that graph's stream. On
    the CPU, and on a mesh of more than one rank, every step runs op by op
    in the same order. The dropout keys are the global step's, so the
    grouping changes no result: any K trains to the same bits as K = 1. The
    card's graphs run the eager step's kernels, so under
    ``cudnn.deterministic`` they give an eager loop of ``seg_train_step``'s
    bits (DeepLabV3's upsample has no atomics in its backward).

    ``mesh``: JAX's data-parallel layout. Each rank takes shard d of the
    dataset wrapped around to D·n_local rows (n_local = ceil(N / D)), and
    each epoch draws D permutations of n_local from the one generator (every
    rank draws them all, and walks row d); step t takes each shard's t-th
    block of batch/D indices, a short last block repeating its last index
    with weight 0. A batch the data axis does not divide is left unsharded
    (every rank runs it whole), with a line in the log, as in JAX."""
    dev = next(state.model.parameters()).device
    images = _as_device_tensor(images, dev)
    masks = _as_device_tensor(masks, dev)
    n = images.shape[0]
    D = 1 if mesh is None else mesh.data
    dp = D > 1
    if mesh is not None:
        mesh.require_distributed("train_segmentation_model")
    if dp and batch_size % D:
        log(f"[Run {run_id}] batch {batch_size} not divisible by data axis {D}; "
            "inputs left unsharded")
        dp = False
    if dp:
        n_local = -(-n // D)
        d = mesh.index("data")
        rows = (torch.arange(d * n_local, (d + 1) * n_local) % n).to(dev)  # wrap-around padding
        images, masks = images[rows], masks[rows]
        b = batch_size // D
        T = -(-n_local // b)
    else:
        b = batch_size
        T = -(-n // b)
    K = max(1, steps_per_dispatch)
    graphed = dev.type == "cuda" and (mesh is None or mesh.size == 1)
    if graphed:
        prog = _epoch_programs(state, images, masks, b, seg_size, loss_fn, K)
    else:
        prog = _EagerEpochs(b, seg_size, loss_fn, mesh if dp else None, dev)
    rng = np.random.default_rng(seed)
    final_loss = 0.0
    for epoch in range(num_epochs):
        if dp:
            order = np.stack([rng.permutation(n_local) for _ in range(D)])[d]
        else:
            order = rng.permutation(n)
        table = _epoch_table([order[t * b:(t + 1) * b] for t in range(T)], b,
                             [dropout_seed(seed + 1, epoch, t) for t in range(T)])
        dev_table = _stage(table, dev)
        prog.acc.zero_()
        # full chunks of K steps run as one dispatch; the ragged tail (and a
        # partly valid last step) as single steps, as in JAX
        full_T = T if table[-1, b:2 * b].all() else T - 1
        cursor = 0
        while K > 1 and cursor + K <= full_T:
            prog.run(dev_table[cursor:cursor + K], state, images, masks)
            state.step += K
            cursor += K
        for t in range(cursor, T):
            prog.run(dev_table[t:t + 1], state, images, masks)
            state.step += 1
        final_loss = float(prog.acc)
        log(f"[Run {run_id}] Epoch {epoch + 1}/{num_epochs}, Loss: {final_loss:.4f}")
        if eval_fn is not None:
            avg_iou, avg_acc = eval_fn(state)
            log(f"[Run {run_id}] Validation IoU: {avg_iou:.4f}, Accuracy: {avg_acc:.4f}")
    return state, final_loss


def _padded_index_table(n: int, batch_size: int):
    """[T,B] indices over n rows (the ragged tail repeats the last one) and
    the [T,B] mask of real rows."""
    T = (n + batch_size - 1) // batch_size
    idx = np.concatenate([np.arange(n), np.repeat(n - 1, T * batch_size - n)])
    valid = np.arange(T * batch_size) < n
    return idx.reshape(T, batch_size), valid.reshape(T, batch_size)


def _predict(model: torch.nn.Module, raw: torch.Tensor, seg_size: int, normalize: bool):
    """[B,H,W,3] uint8 → [B,seg_size,seg_size] argmax classes."""
    x, _ = preprocess_batch(raw, None, size=seg_size)
    if normalize:
        x = _normalize_images(x)
    return model(x.permute(0, 3, 1, 2)).argmax(dim=1)


def _binary_truth(trimaps: torch.Tensor, eval_size: int | None, binarize: str) -> torch.Tensor:
    t = trimaps.to(torch.int32)
    if eval_size is not None and t.shape[1] != eval_size:
        t = resize_nearest(t, (eval_size, eval_size), torch_legacy=False, axes=(1, 2))
    if binarize == "fg1":
        return (t == 1).to(torch.int32)  # the reference's binarisation (:142)
    if binarize == "shifted_inverted":
        return 1 - (t - 1).clamp(min=0).clamp(0, 1)
    raise ValueError(f"unknown binarize {binarize!r}; expected one of {BINARIZE}")


def _fit_preds(preds: torch.Tensor, truth: torch.Tensor) -> torch.Tensor:
    if preds.shape[1:] != truth.shape[1:]:
        preds = resize_nearest(preds, tuple(truth.shape[1:3]), torch_legacy=True, axes=(1, 2))
    return preds


def _per_image_metrics(model, raw, trimaps, seg_size, eval_size, normalize, binarize):
    """Per-image (IoU, accuracy) of one batch, each [B]."""
    truth = _binary_truth(trimaps, eval_size, binarize)
    return compute_iou_and_acc(_fit_preds(_predict(model, raw, seg_size, normalize), truth),
                               truth)


def _multiclass_metrics(model, raw, trimaps, num_classes, seg_size, normalize, valid=None):
    """One batch's (nanmean per-class IoU, pixel accuracy), 0-dim tensors."""
    masks = (trimaps.to(torch.int32) == 1).to(torch.int32)
    preds = _fit_preds(_predict(model, raw, seg_size, normalize), masks)
    _, mean_iou, pixel_acc = per_class_iou(preds, masks, num_classes, valid=valid)
    return mean_iou, pixel_acc


@torch.no_grad()
def evaluate_segmentation_dataset(model: torch.nn.Module, images_u8, trimaps,
                                  batch_size: int = 8, seg_size: int = 256,
                                  eval_size: int | None = 224, log=None):
    """Mean per-image (IoU, accuracy) over the test set (images [N,H,W,3]
    uint8, trimaps [N,h,w] uint8, numpy or tensors)."""
    dev = next(model.parameters()).device
    model.eval()
    images_u8 = _as_device_tensor(images_u8, dev)
    trimaps = _as_device_tensor(trimaps, dev)
    n = images_u8.shape[0]
    s_iou = torch.zeros((), device=dev)
    s_acc = torch.zeros((), device=dev)
    for idx in torch.from_numpy(np.arange(n)).to(dev).split(batch_size):
        iou_b, acc_b = _per_image_metrics(model, images_u8[idx], trimaps[idx], seg_size,
                                          eval_size, True, "fg1")
        s_iou += iou_b.sum()
        s_acc += acc_b.sum()
    avg_iou, avg_acc = float(s_iou) / n, float(s_acc) / n
    if log:
        log(f"\n Model Evaluation on Test Set: IoU = {avg_iou:.4f} | Acc = {avg_acc:.4f}")
    return avg_iou, avg_acc


@torch.no_grad()
def evaluate_segmentation_sharded(model: torch.nn.Module, images, true_fg, mesh):
    """Binary (IoU, accuracy) of the model's argmax on normalised [N,H,W,3]
    ``images`` against [N,H,W] {0,1} ``true_fg`` (numpy or tensors, the same
    on every rank): each rank predicts its rows on the 'data' axis and the
    confusion counters are summed over the axis in one all-reduce."""
    model.eval()
    x, truth = shard_batch(mesh, images, true_fg)
    preds = model(x.permute(0, 3, 1, 2)).argmax(dim=1)
    c = binary_confusion_counts(preds, truth)
    if mesh.data > 1:
        keys = list(c)
        summed = all_reduce_value(torch.stack([c[k].long() for k in keys]), mesh.group("data"))
        c = dict(zip(keys, summed))
    iou, acc = finish_iou_and_acc(c)
    return float(iou), float(acc)


@torch.no_grad()
def evaluate_segmentation(model: torch.nn.Module, loader, seg_size: int = 256,
                          eval_size: int | None = 224, binarize: str = "fg1",
                          normalize: bool = True, log=None):
    """``evaluate_segmentation_dataset``'s metrics over a loader of padded
    batches (``image``, ``trimap``, ``num_valid``), with the truth binarised
    by ``binarize``."""
    dev = next(model.parameters()).device
    model.eval()
    ious, accs = [], []
    for batch in loader:
        iou_b, acc_b = _per_image_metrics(
            model, _as_device_tensor(batch.image, dev), _as_device_tensor(batch.trimap, dev),
            seg_size, eval_size, normalize, binarize)
        ious.extend(iou_b[: batch.num_valid].tolist())
        accs.extend(acc_b[: batch.num_valid].tolist())
    avg_iou, avg_acc = sum(ious) / len(ious), sum(accs) / len(accs)
    if log:
        log(f"\n Model Evaluation on Test Set: IoU = {avg_iou:.4f} | Acc = {avg_acc:.4f}")
    return avg_iou, avg_acc


@torch.no_grad()
def evaluate_multiclass_dataset(model: torch.nn.Module, images_u8, trimaps,
                                num_classes: int = 2, batch_size: int = 8,
                                seg_size: int = 256, normalize: bool = True, log=None):
    """The supervised baseline's metrics over the test set (images [N,H,W,3]
    uint8, trimaps [N,h,w] uint8, numpy or tensors) in fixed-shape batches,
    the padded rows of the last one out of every counter. Returns (acc, iou)."""
    dev = next(model.parameters()).device
    model.eval()
    images_u8 = _as_device_tensor(images_u8, dev)
    trimaps = _as_device_tensor(trimaps, dev)
    idx_table, valid_table = _padded_index_table(images_u8.shape[0], batch_size)
    s_iou = torch.zeros((), device=dev)
    s_acc = torch.zeros((), device=dev)
    for idx, valid in zip(torch.from_numpy(idx_table).to(dev),
                          torch.from_numpy(valid_table).to(dev)):
        mean_iou, pixel_acc = _multiclass_metrics(model, images_u8[idx], trimaps[idx],
                                                  num_classes, seg_size, normalize, valid)
        s_iou += mean_iou
        s_acc += pixel_acc
    T = idx_table.shape[0]
    avg_acc, avg_iou = float(s_acc) / T, float(s_iou) / T
    if log:
        log(f"Val Acc: {avg_acc:.4f} | Val IoU: {avg_iou:.4f}")
    return avg_acc, avg_iou


@torch.no_grad()
def evaluate_multiclass(model: torch.nn.Module, loader, num_classes: int = 2,
                        seg_size: int = 256, normalize: bool = True, log=None):
    """``evaluate_multiclass_dataset``'s metrics over a loader of padded
    batches (``image``, ``trimap``, ``num_valid``). Returns (acc, iou)."""
    dev = next(model.parameters()).device
    model.eval()
    total_acc = total_iou = 0.0
    batches_n = 0
    for batch in loader:
        k = batch.num_valid
        mean_iou, pixel_acc = _multiclass_metrics(
            model, _as_device_tensor(batch.image[:k], dev),
            _as_device_tensor(batch.trimap[:k], dev), num_classes, seg_size, normalize)
        total_iou += float(mean_iou)
        total_acc += float(pixel_acc)
        batches_n += 1
    avg_acc, avg_iou = total_acc / batches_n, total_iou / batches_n
    if log:
        log(f"Val Acc: {avg_acc:.4f} | Val IoU: {avg_iou:.4f}")
    return avg_acc, avg_iou
