"""Per-phase wall-clock timing (port of ``Stopwatch`` from
weaklysuperviseddl_tpu/utils/profiling.py).

PyTorch returns before the card finishes, so on a CUDA device each phase ends
with ``torch.cuda.synchronize()``: a phase's seconds cover the device work it
launched.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


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
