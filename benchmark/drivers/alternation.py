"""The alternating round of weakly-supervised training: DeepLabV3 trained on a
resident store of pseudo-masks, then refinement sweeps over every mask, then
the masks written back to the store (``train/alternating.run_alternating_training``).

Set-up builds one training state (the model with the benchmark's weights,
``GuardedAdam``), fills a ``MaskStore`` with the seeded pets and their
trimaps' foreground, uploads it once (``upload_store_resident``), and drives
the state through its first steps by the window's own call,
``train_segmentation_model``, on distinct rows of the store: step 1 alone
(a one-step graph), so that Adam's first moment can be read after it, then
steps 2 to 9 as one call over 32 rows, which runs them as one graphed chunk
of K = 8 steps, the chunk that runs most of the window's steps. It then
warms up the window's programs: one epoch over the resident store (the
graphed K-step chunks and the one-step graph) and one sweep batch (the
sweep's graph), and wraps the memoised sweep so that each call records the
masks it starts from and its summed refinement loss. A unit of the window is
one round.

``check`` holds the program to ``reference/train.py``: step 1's loss, the
chunk's summed loss, the first gradient as Adam holds it after step 1
(m / (1 − β1)) and each parameter's change over the 9 steps, both by the
worst leaf; and, after the window, the last round's sweep over every mask of
the store: its summed loss (K1's) and its written-back masks against the
reference's refinement of the masks it started from, with the program's
final weights.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import inspect
import sys

import numpy as np
import torch

from benchmark.models import program_model, reference_model, set_precision

RATE = "train_img_per_s"
ADAM_B1 = 0.9


def _quiet(*_args, **_kwargs):
    pass


def _experiment(run):
    from weaklysuperviseddl_tpu_torch.config import (
        AlternatingConfig, DataConfig, ExperimentConfig, RefineConfig, SegConfig)

    p = run.params
    refine = RefineConfig(**p["refine"])
    return ExperimentConfig(
        data=DataConfig(image_size=p["image_size"], seg_size=run.config["image_size"]),
        seg=SegConfig(batch_size=p["batch_size"], loss_fn=p["loss_fn"], lr=p["lr"]),
        alternating=AlternatingConfig(epochs_per_round=p["epochs_per_round"],
                                      refine_repeats=p["refine_repeats"], refine=refine),
        seed=run.seed)


class RecordedSweep:
    """The memoised sweep of ``make_refine_sweep``, wrapped on the
    benchmark's side: each call keeps a device copy of the masks it starts
    from and its summed loss (a device scalar, read after the window)."""

    def __init__(self, sweep):
        self.sweep = sweep
        self.model = sweep.model          # make_refine_sweep checks the entry's model
        self.masks_in = None
        self.loss = None

    def __call__(self, dev_masks, dev_images, idx_table):
        self.masks_in = dev_masks.clone()
        self.loss = self.sweep(dev_masks, dev_images, idx_table)
        return self.loss


@dataclasses.dataclass
class State:
    seg: object
    store: object
    resident: tuple
    cfg: object
    images: np.ndarray               # the store's uint8 images, as the benchmark made them
    first: dict                      # the first steps: rows, seeds, readings
    sweep: RecordedSweep
    stopwatch: object = None
    n_store: int = 0


def _chunk_steps() -> int:
    from weaklysuperviseddl_tpu_torch.train.segmentation import train_segmentation_model

    return inspect.signature(train_segmentation_model).parameters["steps_per_dispatch"].default


def first_steps(seg, images: torch.Tensor, masks: torch.Tensor, rows: np.ndarray,
                seeds: list[int], run, weights: dict) -> dict:
    """The state's first steps on the store's ``rows`` (a [steps, batch]
    table): ``train_segmentation_model`` on row 0's batch (one step), then on
    the other rows' batches together (one epoch of K steps, one graphed
    chunk). Returns the two calls' losses, each leaf's first-gradient norm
    (from Adam's m after step 1) and each leaf's change over the steps."""
    from weaklysuperviseddl_tpu_torch.train.segmentation import train_segmentation_model

    p = run.params
    b = rows.shape[1]
    if rows.shape[0] - 1 != _chunk_steps():
        raise ValueError(f"{rows.shape[0]} first steps are not 1 + one chunk of "
                         f"{_chunk_steps()}")
    names = [n for n, _ in seg.model.named_parameters()]
    losses, grad_norms = [], None
    for k, (r, s) in enumerate(((rows[:1], seeds[0]), (rows[1:], seeds[1]))):
        idx = torch.from_numpy(r.reshape(-1)).to(images.device)
        seg, loss = train_segmentation_model(seg, images[idx], masks[idx], loss_fn=p["loss_fn"],
                                             num_epochs=1, batch_size=b,
                                             seg_size=run.config["image_size"], seed=s,
                                             log=_quiet)
        losses.append(loss)
        if k == 0:
            grad_norms = [float(m.norm()) / (1.0 - ADAM_B1) for m in seg.optimizer.m]
    with torch.no_grad():
        change = [float((p_ - weights[n]).norm())
                  for n, p_ in zip(names, seg.model.parameters())]
    return {"names": names, "losses": losses, "grad_norms": grad_norms, "change_norms": change,
            "running_means": running_means(seg.model)}


def running_means(model) -> dict:
    """BatchNorm's running means by name, on the host: each a weighted sum
    of the steps' batch means, so they hold which rows each step took and,
    after the head's dropout, which units it dropped."""
    return {n: b.detach().cpu().clone() for n, b in model.named_buffers()
            if n.endswith("running_mean")}


def store_inputs(run):
    """The store's uint8 images and {0,1} masks (the seeded pets' trimap
    foreground) as host arrays, and the first steps' rows ([steps, batch],
    distinct), the two calls' seeds and their images and masks."""
    from benchmark.inputs import pets

    p = run.params
    n, size, b, steps = p["store_size"], p["image_size"], p["batch_size"], p["first_steps"]
    images, _, trimaps = pets(n, size, size, run.seed + 1, run.device)
    images_np = images.cpu().numpy()
    masks_np = (trimaps == 1).to(torch.uint8).cpu().numpy()
    rng = np.random.default_rng(run.seed)
    rows = rng.permutation(n)[:b * steps].reshape(steps, b)
    seeds = [int(s) for s in rng.integers(0, 2**62, size=2)]
    first = {"rows": rows, "seeds": seeds, "images": images_np[rows.reshape(-1)],
             "masks": masks_np[rows.reshape(-1)]}
    return images_np, masks_np, first


def prepare(run):
    """The training state with the benchmark's weights, the store and its
    upload, and the state driven through its first steps: (state, store,
    resident, keys, images, first)."""
    from weaklysuperviseddl_tpu_torch.data.mask_store import MaskStore
    from weaklysuperviseddl_tpu_torch.train.alternating import upload_store_resident
    from weaklysuperviseddl_tpu_torch.train.guard import GuardedAdam
    from weaklysuperviseddl_tpu_torch.train.segmentation import SegTrainState

    from benchmark.inputs import make_weights

    p, cfg_m, dev = run.params, run.config, run.device
    set_precision(cfg_m)
    weights = make_weights(reference_model(cfg_m), run.seed, dev)
    model = program_model(cfg_m, weights, dev)
    seg = SegTrainState(model=model, optimizer=GuardedAdam(model.parameters(), lr=p["lr"]))
    images_np, masks_np, first = store_inputs(run)
    store = MaskStore()
    keys = [f"{i:05d}" for i in range(len(images_np))]
    for i, k in enumerate(keys):
        store.put(k, images_np[i], masks_np[i])
    resident = upload_store_resident(store, cfg_m["image_size"], dev)
    first["readings"] = first_steps(seg, resident[0], resident[1], first["rows"],
                                    first["seeds"], run, weights)
    return seg, store, resident, keys, images_np, first


def setup(run):
    from weaklysuperviseddl_tpu_torch.train import alternating
    from weaklysuperviseddl_tpu_torch.train.segmentation import train_segmentation_model
    from weaklysuperviseddl_tpu_torch.utils.profiling import Stopwatch

    p, cfg_m, dev = run.params, run.config, run.device
    seg, store, resident, keys, images_np, first = prepare(run)
    n, b = len(keys), p["batch_size"]
    cfg = _experiment(run)
    size = cfg_m["image_size"]
    # warm-up: the window's training programs and its sweep graph
    train_segmentation_model(seg, resident[0], resident[1], loss_fn=p["loss_fn"], num_epochs=1,
                             batch_size=b, seg_size=size, seed=run.seed + 2**40, log=_quiet)
    sweep = alternating.make_refine_sweep(seg.model, cfg.alternating.refine, size)
    sweep(resident[1], resident[0], torch.arange(b, device=dev).view(1, b))
    for i in range(b):   # the warm-up batch's masks, as a round writes them back
        store.update_mask(keys[i], resident[1][i].cpu().numpy())
    recorded = RecordedSweep(sweep)
    alternating._SWEEP_PROGRAMS.put((id(seg.model), cfg.alternating.refine, size), recorded)
    state = State(seg=seg, store=store, resident=resident, cfg=cfg, images=images_np,
                  first=first, sweep=recorded, n_store=n)
    if run.trace:
        state.stopwatch = Stopwatch(device=dev)
    run.extra.update(rounds=0, steps_per_round=-(-n // b) * p["epochs_per_round"],
                     sweep_batches_per_round=-(-n // b) * p["refine_repeats"], batch=b)
    return state


def unit(state: State, run, index: int) -> float:
    from weaklysuperviseddl_tpu_torch.ops.refine import refine_cuda
    from weaklysuperviseddl_tpu_torch.train.alternating import run_alternating_training

    cfg = dataclasses.replace(state.cfg, alternating=dataclasses.replace(
        state.cfg.alternating, num_alternations=index + 1))
    k1 = refine_cuda.launches
    with run.spans("round"):
        state.seg, state.store = run_alternating_training(
            state.seg, state.store, cfg, start_iteration=index, stopwatch=state.stopwatch,
            log=_quiet, resident=state.resident)
    run.extra["rounds"] += 1
    if run.traced_unit == index:
        run.extra["traced_k1_launches"] = refine_cuda.launches - k1
    if state.stopwatch is not None:
        run.extra["stopwatch"] = state.stopwatch
    return state.n_store * run.params["epochs_per_round"]


def leaf_gaps(program: list[float], reference: list[float], keep=None) -> list[float]:
    """Each leaf's gap between two lists of per-leaf norms: |a − b| over the
    larger of the reference leaf's norm and the median leaf's."""
    keep = range(len(reference)) if keep is None else keep
    ref = [reference[i] for i in keep]
    median = float(np.median(ref))
    return [abs(program[i] - reference[i]) / max(reference[i], median) for i in keep]


def reference_first_steps(run, first: dict, tf32: bool = False) -> dict:
    """The reference's readings of the first steps, from the seed's weights
    and the same rows, batch order and dropout keys as the program's two
    calls; its losses as the calls return them (step 1's, and the sum of
    steps 2 to 9)."""
    from benchmark.inputs import make_weights
    from benchmark.reference.dropout import step_key
    from benchmark.reference.train import precision, train_steps

    dev, cfg_m = run.device, run.config
    model = reference_model(cfg_m, "meta").to_empty(device=dev)
    w0 = make_weights(reference_model(cfg_m), run.seed, dev)
    model.load_state_dict(w0)
    b = first["rows"].shape[1]
    batches = []
    for k, (start, steps) in enumerate(((0, 1), (b, first["rows"].shape[0] - 1))):
        s = first["seeds"][k]
        order = start + np.random.default_rng(s).permutation(b * steps)   # the epoch's order
        for t in range(steps):
            rows = order[t * b:(t + 1) * b]
            batches.append((torch.from_numpy(first["images"][rows]).to(dev),
                            torch.from_numpy(first["masks"][rows]).to(dev), step_key(s, 0, t)))
    with precision(tf32):
        out = train_steps(model, batches, cfg_m["image_size"], lr=run.params["lr"])
    names = list(out["params"])
    return {"names": names, "losses": [out["losses"][0], sum(out["losses"][1:])],
            "grad_norms": [float(out["first_grads"][n].norm()) for n in names],
            "change_norms": [float((out["params"][n] - w0[n]).norm()) for n in names],
            "running_means": running_means(model)}


def compare_first_steps(prog: dict, ref: dict) -> dict:
    """The training numbers: the relative gap of step 1's loss and of the
    chunk's summed loss; the worst leaf's gap of the first gradient's norm
    and of the change's norm, and the median leaf's of the change; and the
    gap of the first and the last BatchNorm's running means (the stem's,
    which holds the rows the steps took, and the head's after the dropout),
    as the norm of their difference over the larger of the reference's norm
    and the median layer's. The change leaves out leaves whose reference gradient is under
    a thousandth of the median leaf's (they move by round-off alone)."""
    if prog["names"] != ref["names"]:
        raise ValueError("the program's parameters are not the reference's")
    a, b = prog["losses"], ref["losses"]
    g = ref["grad_norms"]
    median = float(np.median(g))
    moved = [i for i, v in enumerate(g) if v >= 1e-3 * median]
    change = leaf_gaps(prog["change_norms"], ref["change_norms"], moved)
    rm_p, rm_r = prog["running_means"], ref["running_means"]
    if rm_p.keys() != rm_r.keys():
        raise ValueError("the program's BatchNorm layers are not the reference's")
    scale = [float(rm_r[k].norm()) for k in rm_r]
    median_rm = float(np.median(scale))
    rm = [float((rm_p[k] - rm_r[k]).norm()) / max(n, median_rm) for k, n in zip(rm_r, scale)]
    return {"first_loss_rel_gap": abs(a[0] - b[0]) / abs(b[0]),
            "chunk_loss_rel_gap": abs(a[1] - b[1]) / abs(b[1]),
            "first_grad_leaf_gap": max(leaf_gaps(prog["grad_norms"], g)),
            "change_leaf_gap": max(change),
            "change_median_leaf_gap": float(np.median(change)),
            "stem_running_mean_gap": rm[0],
            "head_running_mean_gap": rm[-1]}


def reference_sweep(run, weights: dict, images: np.ndarray, masks_in: torch.Tensor,
                    tf32: bool = False, block: int = 25):
    """The reference's sweep over every mask of the store: the model with
    ``weights`` in eval mode, its softmax, and the refinement of
    ``masks_in``. Returns (uint8 masks [n,S,S], the summed loss as the
    sweep adds it: each batch's mean over its images, batches of the
    store's rows in order, a ragged tail repeating the last row)."""
    from benchmark.reference.train import precision, preprocess, refine

    p, cfg_m, dev = run.params, run.config, run.device
    rp, size, b = p["refine"], cfg_m["image_size"], p["batch_size"]
    model = reference_model(cfg_m, "meta").to_empty(device=dev)
    model.load_state_dict(weights)
    model.eval()
    out, losses = [], []
    with torch.no_grad(), precision(tf32):
        for s in range(0, len(images), block):
            x = preprocess(torch.from_numpy(images[s:s + block]).to(dev), size)
            S = torch.softmax(model(x), dim=1)
            m, loss = refine(S, x, masks_in[s:s + block].to(dev), rp["lr"], rp["num_steps"],
                             rp["lambda_boundary"], rp["threshold"], rp["sigma_color"],
                             rp["window_size"])
            out.append(m.cpu())
            losses.append(loss.cpu())
    n = len(images)
    T = -(-n // b)
    idx = np.concatenate([np.arange(n), np.full(T * b - n, n - 1)]).reshape(T, b)
    per_image = torch.cat(losses).numpy()
    return torch.cat(out).numpy(), float(per_image[idx].mean(axis=1).sum())


def check(state: State, run) -> list:
    """The compared numbers. With ``run.extra["control"]``, the reference
    in TF32 stands in the program's place: its first steps, and its sweep
    over the same masks with the same weights."""
    final = {k: v.detach().cpu() for k, v in state.seg.model.state_dict().items()}
    keys = state.store.keys()
    written = np.stack([state.store.get(k)[1] for k in keys])
    masks_in = state.sweep.masks_in.cpu()
    sweep_loss = float(state.sweep.loss)
    images, first = state.images, state.first
    state.seg = state.store = state.resident = state.sweep = None
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()

    control = bool(run.extra.get("control"))
    got = reference_first_steps(run, first, tf32=True) if control else first["readings"]
    numbers = compare_first_steps(got, reference_first_steps(run, first))
    want_masks, want_loss = reference_sweep(run, final, images, masks_in)
    if control:
        written, sweep_loss = reference_sweep(run, final, images, masks_in, tf32=True)
    numbers["sweep_loss_rel_gap"] = abs(sweep_loss - want_loss) / abs(want_loss)
    numbers["sweep_mask_mismatch_px"] = int((written != want_masks).sum())
    run.extra.setdefault("notes", {}).update(
        {k: v for k, v in numbers.items() if k not in run.limits})
    return [(name, numbers[name], limit) for name, limit in run.limits.items()]


def _half_batch(train_step):
    """``_train_step`` with the second half of every batch left out of the
    loss: the mean is taken over the first half."""
    def step(state, images, masks, valid, loss_fn, mesh):
        valid = valid.clone()
        valid[valid.shape[0] // 2:] = False
        return train_step(state, images, masks, valid, loss_fn, mesh)
    return step


CHUNK_FAULTS = ("chunk_rows", "chunk_repeat", "chunk_dropout", "chunk_frozen")


def _chunk_fault(run_chunk, mode: str):
    """An epoch program's ``run(rows, state, images, masks)`` broken for
    chunks of more than one step: each step on the next rows of the dataset
    (``chunk_rows``), every step on the first step's rows (``chunk_repeat``),
    every step with the first step's dropout key (``chunk_dropout``), or the
    state left as it was before the chunk (``chunk_frozen``)."""
    from weaklysuperviseddl_tpu_torch.train.segmentation import _state_tensors

    def run(self, rows, state, images, masks):
        if rows.shape[0] == 1:
            return run_chunk(self, rows, state, images, masks)
        b = (rows.shape[1] - 1) // 2
        rows = rows.clone()
        if mode == "chunk_rows":
            rows[:, :b] = (rows[:, :b] + 1) % images.shape[0]
        elif mode == "chunk_repeat":
            rows[:, :b] = rows[:1, :b]
        elif mode == "chunk_dropout":
            rows[:, 2 * b] = rows[0, 2 * b]
        saved = ([t.detach().clone() for t in _state_tensors(state)]
                 if mode == "chunk_frozen" else None)
        out = run_chunk(self, rows, state, images, masks)
        if saved is not None:
            with torch.no_grad():
                for t, s in zip(_state_tensors(state), saved):
                    t.copy_(s)
        return out
    return run


@contextlib.contextmanager
def plant(mode: str):
    """The program's training broken underneath, for the fault readings and
    tests: ``half_batch`` or one of ``CHUNK_FAULTS``."""
    from weaklysuperviseddl_tpu_torch.train import segmentation

    if mode == "half_batch":
        targets = [(segmentation, "_train_step", _half_batch(segmentation._train_step))]
    elif mode in CHUNK_FAULTS:
        targets = [(cls, "run", _chunk_fault(cls.run, mode))
                   for cls in (segmentation._GraphEpochs, segmentation._EagerEpochs)]
    else:
        raise ValueError(f"unknown fault {mode!r}")
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in targets]
    try:
        for obj, name, fn in targets:
            setattr(obj, name, fn)
        yield
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)


LIMIT_MODES = ("control", "program_first", "half_batch", *CHUNK_FAULTS)


def limit_readings(run, mode: str) -> dict:
    """One seed's numbers for the limits. ``control``: a whole run of one
    round, with the reference in TF32 in the program's place in ``check``.
    A fault: the training numbers of the program's first steps with the
    fault planted, against the reference."""
    from benchmark import harness

    if mode == "control":
        run.extra["control"] = True
        checks = harness.measure(run, sys.modules[__name__])["checks"]
        return {name: value for name, value, _ in checks}
    with plant(mode) if mode != "program_first" else contextlib.nullcontext():
        seg, store, resident, keys, _, first = prepare(run)
    del seg, store, resident
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    return compare_first_steps(first["readings"], reference_first_steps(run, first))
