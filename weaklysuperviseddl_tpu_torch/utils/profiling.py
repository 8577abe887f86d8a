"""Timing and tracing (port of weaklysuperviseddl_tpu/utils/profiling.py).

* ``Stopwatch``     — per-phase seconds and image counts, img/s; each phase
                      is also a span.
* ``span``          — a named stretch of the host's work, recorded only while
                      a ``torch.profiler`` session records.
* ``take_spans``    — the recorded spans, taken out of the buffer.
* ``force_ready``   — waits for the device work behind some tensors.
* ``warmup_device`` — times a device's first launch.
* ``trace(dir)``    — a torch.profiler Chrome trace of a block, and the
                      block's spans summed by name beside it.

PyTorch returns before the card finishes, so on a CUDA device each phase ends
with ``torch.cuda.synchronize()``: a phase's seconds cover the device work it
launched. A span never synchronises: around a wait that the program makes it
measures that wait, elsewhere the host's own work (the enqueue of a launch
included, not its device time).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import defaultdict, deque

import torch
from torch.autograd import profiler as _autograd_profiler

from weaklysuperviseddl_tpu_torch.device import resolve_device

# the prefix of a span's record_function range, apart from the benchmark's
# own ``bench/`` ranges
SPAN_PREFIX = "wsdl/"
_SPANS: deque = deque(maxlen=1 << 16)   # finished spans, oldest dropped first
_SPAN_IDS = itertools.count(1)
_STACKS = threading.local()             # each thread's open spans


class _NoSpan:
    """What ``span`` returns while no profiler records: it does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def _open_spans() -> list:
    stack = getattr(_STACKS, "stack", None)
    if stack is None:
        stack = _STACKS.stack = []
    return stack


class Span:
    """A recorded span: ``name``, ``start`` and ``end`` (seconds on the
    host's monotonic clock), ``id``, ``parent`` (the id of the span open on
    the same thread when it began, or None), ``thread`` (its thread's id)
    and ``attrs`` (such as ``bytes``, ``items``, a batch's ``dispatch`` id or
    a request's ``rid``). As a context manager it records the block it
    encloses, inside a ``record_function`` range ``wsdl/<name>``."""

    __slots__ = ("name", "attrs", "id", "parent", "thread", "start", "end", "_range")

    def __init__(self, name: str, attrs: dict, start: float = 0.0, end: float = 0.0):
        self.name, self.attrs = name, attrs
        self.id = next(_SPAN_IDS)
        self.parent = None
        self.thread = threading.get_ident()
        self.start, self.end = start, end
        self._range = None

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def __enter__(self):
        stack = _open_spans()
        self.parent = stack[-1].id if stack else None
        stack.append(self)
        self._range = torch.profiler.record_function(SPAN_PREFIX + self.name)
        self._range.__enter__()
        self.start = time.monotonic()
        return self

    def __exit__(self, *exc):
        self.end = time.monotonic()
        self._range.__exit__(*exc)
        self._range = None
        _open_spans().pop()
        _SPANS.append(self)
        return False


def span(name: str, **attrs):
    """A context that records the block it encloses as the span ``name``
    with ``attrs``, while a ``torch.profiler`` session records. Otherwise it
    costs one read of the profiler's flag and returns a shared context that
    does nothing: no ``record_function``, no object made, no
    synchronisation."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return Span(name, attrs)


def record_span(name: str, start: float, end: float, **attrs) -> None:
    """Record a span from two ``time.monotonic()`` stamps, while a profiler
    session records: for a stretch that begins on one thread and ends on
    another (a request's wait in a queue), which no ``with`` block can
    enclose. It has no parent and no ``record_function`` range."""
    if _autograd_profiler._is_profiler_enabled:
        _SPANS.append(Span(name, attrs, start, end))


def take_spans() -> list[Span]:
    """The recorded spans, oldest first, taken out of the buffer (which
    keeps the newest 65,536)."""
    out = []
    while True:
        try:
            out.append(_SPANS.popleft())
        except IndexError:
            return out


def self_seconds(spans: list[Span]) -> dict[int, float]:
    """Each span's self time by id: its seconds less those of its children
    among ``spans`` (a child opens and closes inside its parent, on its
    thread, one after another)."""
    own = {sp.id: sp.seconds for sp in spans}
    for sp in spans:
        if sp.parent in own:
            own[sp.parent] -= sp.seconds
    return own


def span_totals(spans: list[Span]) -> dict[str, dict]:
    """Per span name: ``count``, ``total_ms``, ``self_ms`` and ``parents``
    (the names of the spans its spans were opened in)."""
    own = self_seconds(spans)
    names = {sp.id: sp.name for sp in spans}
    out: dict[str, dict] = {}
    for sp in spans:
        t = out.setdefault(sp.name, {"count": 0, "total_ms": 0.0, "self_ms": 0.0,
                                     "parents": []})
        t["count"] += 1
        t["total_ms"] += sp.seconds * 1e3
        t["self_ms"] += own[sp.id] * 1e3
        parent = names.get(sp.parent)
        if parent is not None and parent not in t["parents"]:
            t["parents"].append(parent)
    return out


def idle_gaps(events: list[dict]) -> list[dict]:
    """The device's ten longest idle gaps in a Chrome trace's events
    (between its kernels, copies and memsets), longest first, each named by
    the innermost (shortest) ``wsdl/`` range open on the host when it began
    (None: none was): ``{"span", "ms", "at_ms"}``, ``at_ms`` from the first
    device operation."""
    device = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                    for e in events if e.get("ph") == "X"
                    and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    ranges = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
               e["name"][len(SPAN_PREFIX):])
              for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
              and str(e.get("name", "")).startswith(SPAN_PREFIX)]
    gaps, end = [], None
    for s, e in device:
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    gaps.sort(key=lambda g: g[0] - g[1])

    def host_at(t):
        open_ = [r for r in ranges if r[0] <= t < r[1]]
        return min(open_, key=lambda r: r[1] - r[0])[2] if open_ else None

    t0 = device[0][0] if device else 0.0
    return [{"span": host_at(a), "ms": (b - a) / 1e3, "at_ms": (a - t0) / 1e3}
            for a, b in gaps[:10]]


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
            with span(name, images=images):
                try:
                    yield
                finally:
                    self._sync()
        finally:
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
    Perfetto or chrome://tracing, where each span is a ``wsdl/<name>``
    range. Beside it ``log_dir/spans.json`` holds the block's spans by name
    (``spans``: count, total and self ms, parents) and the device's ten
    longest idle gaps, each named by the innermost span open on the host
    when it began (``idle_gaps``). The profiler keeps the ranges of the
    thread that runs the block; spans of other threads (a server's) are in
    ``spans.json`` alone. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    take_spans()                        # spans that no earlier session took
    with profile(activities=activities) as prof:
        yield prof
    spans = take_spans()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump({"spans": span_totals(spans), "idle_gaps": idle_gaps(events)}, f,
                  indent=1)
