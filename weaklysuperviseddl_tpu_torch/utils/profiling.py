"""Timing and tracing (port of weaklysuperviseddl_tpu/utils/profiling.py).

* ``Stopwatch``        — per-phase seconds and image counts, img/s.
* ``force_ready``      — waits for the device work behind some tensors.
* ``warmup_device``    — times a device's first launch.
* ``trace(dir)``       — a torch.profiler Chrome trace of a block.
* ``log_compile_time`` — reports a function's first-call seconds.

PyTorch returns before the card finishes, so on a CUDA device each phase ends
with ``torch.cuda.synchronize()``: a phase's seconds cover the device work it
launched.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch

from weaklysuperviseddl_tpu_torch.device import resolve_device


def _tensors(value):
    """The tensors in nested tuples, lists and dicts."""
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, dict):
        for v in value.values():
            yield from _tensors(v)
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _tensors(v)


def force_ready(value):
    """Wait until the device work behind every tensor in ``value`` (a tensor
    or nested tuples, lists and dicts of them) has finished: one
    ``torch.cuda.synchronize`` per CUDA device among them. Returns ``value``."""
    for dev in {t.device for t in _tensors(value) if t.is_cuda}:
        torch.cuda.synchronize(dev)
    return value


class Stopwatch:
    """Accumulates per-phase seconds and image counts; reports images/s.
    ``device``: the device whose work a phase must wait for (None: the host
    clock alone)."""

    def __init__(self, device: torch.device | str | None = None):
        self.device = None if device is None else torch.device(device)
        self.times = defaultdict(float)
        self.counts = defaultdict(int)
        self.images = defaultdict(int)
        # per-call (seconds, images): first-call and marginal rates differ when
        # a phase's first call pays one-time costs (kernel builds, cuDNN plans)
        self.calls = defaultdict(list)

    def _sync(self):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str, images: int = 0):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            dt = time.perf_counter() - t0
            self.times[name] += dt
            self.counts[name] += 1
            self.images[name] += images
            self.calls[name].append((dt, images))

    def report(self, log=print):
        for name in self.times:
            line = f"[profile] {name}: {self.times[name]:.3f}s over {self.counts[name]} calls"
            if self.images[name]:
                line += f" = {self.images[name] / self.times[name]:.1f} img/s"
                m = self.marginal_rate(name)
                if m is not None:
                    line += f" (marginal {m:.1f} img/s after first call)"
            log(line)

    def rate(self, name: str) -> float:
        return self.images[name] / self.times[name] if self.times[name] else 0.0

    def marginal_rate(self, name: str) -> float | None:
        """img/s over calls 2..N; None when the phase ran fewer than 2 calls."""
        tail = self.calls[name][1:]
        secs = sum(t for t, _ in tail)
        imgs = sum(i for _, i in tail)
        if not tail or secs <= 0 or imgs <= 0:
            return None
        return imgs / secs

    def first_call_s(self, name: str) -> float | None:
        return self.calls[name][0][0] if self.calls[name] else None


def warmup_device(device=None, warn_after_s: float = 60.0, log=print) -> float:
    """Pay a device's first-launch cost in a phase of its own and return its
    seconds: CUDA's context and first kernel on a card (``device=None`` is
    the card, ``device.resolve_device``), one op on the CPU. Logs the
    device's name, and a warning when it took more than ``warn_after_s``
    (another process holding the card, or a driver that loads slowly), so a
    long stall before a pipeline's first phase is named."""
    dev = resolve_device(device)
    log(f"device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else dev}")
    t0 = time.perf_counter()
    force_ready(torch.ones((), device=dev) + 1)
    dt = time.perf_counter() - t0
    if dt > warn_after_s:
        log(f"[profile] device warmup took {dt:.0f}s: the first launch waited for the "
            "device (another process on it, or a slow driver load), not pipeline cost")
    return dt


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the block with torch.profiler (the CPU, and CUDA where there is
    a card) and write its Chrome trace to ``log_dir/trace.json``, for
    Perfetto or chrome://tracing. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def log_compile_time(fn, name: str | None = None, log=print):
    """Wrap ``fn``: log its first call's seconds, its outputs' device work
    included (``force_ready``): the one-time costs of a first call, such as
    kernel builds and cuDNN's plans."""
    label = name or getattr(fn, "__name__", "fn")
    state = {"first": True}

    def wrapped(*args, **kwargs):
        t0 = time.perf_counter()
        out = force_ready(fn(*args, **kwargs))
        if state["first"]:
            log(f"[profile] {label}: first call {time.perf_counter() - t0:.2f}s")
            state["first"] = False
        return out

    return wrapped
