"""One run of one cell: set-up, the measured window, the per-layer readings
and the comparison with the plain reference.

Everything is found by name:

* the cell ``benchmark/workloads/<cell>.json``: its configuration, its
  traffic mix and driver, the traffic's parameters, and the limits of the
  numbers that decide ``correct``;
* the configuration ``benchmark/configs/<config>.json``;
* the window code of a traffic kind ``benchmark/drivers/<driver>.py``;
* a per-layer metric's reader ``benchmark/metrics/<metric>.py``;
* which metrics a cell reports: ``BENCHMARK.json`` at the checkout's root.

A driver module gives ``RATE`` (the name of the end-to-end rate its units
count), ``setup(run) -> state``, ``unit(state, run, index) -> work done``
(one round, call or pass, finished on the device when it returns) and
``check(state, run) -> [(name, value, limit)]``, which frees the program's
state and runs the reference after the window has closed. Drivers and
readers may leave numbers that are read but not compared in
``run.extra["notes"]``; the result carries them under ``notes``.

The window runs whole units while the next one, at the mean length so far,
still ends inside ``--seconds``; the rate is all the work over all the time
of the units run. With ``--trace 1`` one unit (the second) runs under
``torch.profiler`` and the per-layer readers take the device's kernels, busy
time and idle gaps from it, the program's counters, and the benchmark's own
host spans.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import statistics
import time
from collections import defaultdict
from pathlib import Path

import torch

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
RUN_DIR = ROOT / ".bench_run"          # gitignored: traces of the current run
NAME_CHARS = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_.-")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str) -> dict:
    """The cell's file, with its configuration under ``config_spec``."""
    cell = load_json(BENCH_DIR / "workloads" / f"{name}.json")
    cell["name"] = name
    cell["config_spec"] = load_json(BENCH_DIR / "configs" / f"{cell['config']}.json")
    return cell


def _load_module(path: Path, name: str):
    """The module in ``path``, loaded once a process under ``name``."""
    import sys

    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        try:
            spec.loader.exec_module(module)
        except BaseException:
            del sys.modules[name]
            raise
    return sys.modules[name]


def driver(name: str):
    return _load_module(BENCH_DIR / "drivers" / f"{name}.py", f"benchmark.drivers.{name}")


def reader(metric: str):
    return _load_module(BENCH_DIR / "metrics" / f"{metric}.py",
                        "benchmark_metric_" + metric.replace(".", "_"))


def cell_metrics(name: str, benchmark: dict | None = None) -> tuple[list[dict], list[dict]]:
    """(end-to-end, per-layer) metrics of ``BENCHMARK.json`` that cell
    ``name`` reports: those without ``workloads`` and those that list it."""
    spec = benchmark if benchmark is not None else load_json(ROOT / "BENCHMARK.json")

    def mine(m):
        return "workloads" not in m or name in m["workloads"]

    return ([m for m in spec["end_to_end"] if mine(m)],
            [m for m in spec["per_layer"] if mine(m)])


class Spans:
    """The benchmark's own host spans: seconds by name, and, in a traced
    run, a ``record_function`` range of the same name, so the trace's idle
    gaps can be named by what the host was doing."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.seconds = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = (torch.profiler.record_function(f"bench/{name}") if self.traced
              else contextlib.nullcontext())
        t0 = time.perf_counter()
        with rf:
            try:
                yield
            finally:
                self.seconds[name].append(time.perf_counter() - t0)


class Run:
    """What a run knows: the cell, its configuration and traffic, the seed
    and window, and what the window recorded for the readers."""

    def __init__(self, cell: dict, seed: int, seconds: float, trace: bool, device):
        self.cell = cell
        self.config = cell["config_spec"]
        self.params = cell["params"]
        self.limits = cell["limits"]
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.device = torch.device(device)
        self.spans = Spans(trace)
        self.extra: dict = {}            # counts a driver leaves for the readers
        self.units: list[tuple[float, float]] = []   # (seconds, work) a unit
        self.window_s = 0.0
        self.traced_unit: int | None = None
        self.profile: dict | None = None  # the traced unit's device summary

    @property
    def work(self) -> float:
        return sum(w for _, w in self.units)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def _device_intervals(events: list[dict]) -> list[tuple[float, float, str]]:
    """(start us, end us, name) of every kernel, copy and memset in a Chrome
    trace's events."""
    out = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            out.append((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"]))
    return sorted(out)


def _merge(intervals):
    """(busy us, idle gaps [(start, end)]) of sorted (start, end, name) intervals."""
    busy, gaps, cur = 0.0, [], None
    for s, e, _ in intervals:
        if cur is None or s > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
                gaps.append((cur[1], s))
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        busy += cur[1] - cur[0]
    return busy, gaps


def summarize_trace(path: Path) -> dict:
    """The device's side of a Chrome trace, inside the ``bench/traced_unit``
    span: time and count by kernel name, busy seconds (the union of the
    device's intervals), the span's seconds, and the longest idle gaps, each
    named by the innermost benchmark span open on the host when it began."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
                    e["name"][len("bench/"):])
                   for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and str(e.get("name", "")).startswith("bench/"))
    window = [sp for sp in spans if sp[2] == "traced_unit"]
    dev = _device_intervals(events)
    w0, w1 = (window[0][0], window[0][1]) if window else (
        (dev[0][0], dev[-1][1]) if dev else (0.0, 0.0))
    dev = [(max(s, w0), min(e, w1), n) for s, e, n in dev if min(e, w1) > max(s, w0)]
    by_name = defaultdict(lambda: [0.0, 0])
    for s, e, n in dev:
        by_name[n][0] += (e - s) / 1e3
        by_name[n][1] += 1
    busy, gaps = _merge(dev)

    def host_at(t):
        inner = [sp for sp in spans if sp[0] <= t < sp[1] and sp[2] != "traced_unit"]
        return min(inner, key=lambda sp: sp[1] - sp[0])[2] if inner else "none"

    gaps.sort(key=lambda g: g[0] - g[1])
    return {
        "kernels": {n: {"ms": v[0], "count": v[1]} for n, v in by_name.items()},
        "busy_s": busy / 1e6,
        "window_s": (w1 - w0) / 1e6,
        "device_ops": sorted(([n, v[0] / 1e3] for n, v in by_name.items()),
                             key=lambda kv: -kv[1])[:10],
        "idle_gaps": [[host_at(a), (b - a) / 1e6] for a, b in gaps[:10]],
    }


def _traced(run: Run, fn):
    """Run ``fn()`` under the profiler; returns (its result, the profiler),
    whose trace is read once the window has closed."""
    from torch.profiler import ProfilerActivity, profile

    run.sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with run.spans("traced_unit"):
            out = fn()
            run.sync()
    return out, prof


def _read_trace(run: Run, prof):
    """Keep the traced unit's device summary in ``run``."""
    RUN_DIR.mkdir(exist_ok=True)
    path = RUN_DIR / "trace.json"
    prof.export_chrome_trace(str(path))
    try:
        run.profile = summarize_trace(path)
    finally:
        path.unlink()


def measure(run: Run, drv) -> dict:
    """Set-up, window and check of one run; returns the result's fields."""
    state = drv.setup(run)
    run.sync()
    run.spans.seconds.clear()            # the readers see the window's spans only
    setup_end = time.perf_counter()
    start = setup_end
    index = 0
    prof = None
    while True:
        traced = run.trace and index == 1
        t0 = time.perf_counter()
        if traced:
            run.traced_unit = index
            work, prof = _traced(run, lambda: drv.unit(state, run, index))
        else:
            with run.spans("unit"):
                work = drv.unit(state, run, index)
        run.sync()
        run.units.append((time.perf_counter() - t0, work))
        index += 1
        elapsed = time.perf_counter() - start
        mean = statistics.fmean(s for s, _ in run.units)
        if elapsed + mean > run.seconds and not (run.trace and index < 2):
            break
    run.window_s = time.perf_counter() - start
    if prof is not None:
        _read_trace(run, prof)
        del prof
    peak = (torch.cuda.max_memory_allocated(run.device) if run.device.type == "cuda"
            else 0)
    checks = drv.check(state, run)
    return {"setup_end": setup_end, "peak": peak, "checks": checks}


def result_line(run: Run, drv, fields: dict, setup_s: float, e2e: list[dict],
                per_layer: list[dict], device_info: dict) -> dict:
    """The contract's JSON object: ``correct``, ``attempted``, ``failed``,
    the metrics of the run's kind, ``device``, a traced run's ``breakdown``,
    the notes, and the compared numbers, each with its limit, last."""
    checks = fields["checks"]
    failed = [name for name, value, limit in checks if not value <= limit]
    metrics = {}
    if run.trace:
        for m in per_layer:
            value = reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in e2e:
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": m["unit"]}
            elif m["name"] == drv.RATE:
                metrics[drv.RATE] = {"value": run.work / run.window_s, "unit": m["unit"]}
    device = dict(device_info, memory_peak_bytes=fields["peak"])
    out = {"correct": not failed, "attempted": len(run.units), "failed": 0,
           "metrics": metrics, "device": device}
    if run.trace and run.profile is not None:
        device["busy_s"] = run.profile["busy_s"]
        device["window_s"] = run.profile["window_s"]
        out["breakdown"] = {"device_ops": run.profile["device_ops"],
                            "idle_gaps": run.profile["idle_gaps"]}
    if run.extra.get("notes"):
        out["notes"] = run.extra["notes"]
    out["compared"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool, device, t_start: float,
             benchmark: dict | None = None) -> tuple[dict, Run]:
    """One run of cell ``name`` (or of a cell's dict, as ``load_cell`` gives
    it); returns (the result's object, the run)."""
    cell = load_cell(name) if isinstance(name, str) else name
    name = cell["name"]
    drv = driver(cell["driver"])
    e2e, per_layer = cell_metrics(name, benchmark)
    run = Run(cell, seed, seconds, trace, device)
    fields = measure(run, drv)
    setup_s = fields["setup_end"] - t_start
    if run.device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(run.device),
                "count": 1}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1}
    return result_line(run, drv, fields, setup_s, e2e, per_layer, info), run


def environment() -> dict:
    """Cache directories inside the checkout at fixed paths, and the
    settings that keep libraries from loading JAX."""
    cache = ROOT / ".bench_cache"
    return {"TORCH_EXTENSIONS_DIR": str(cache / "torch_extensions"),
            "TRITON_CACHE_DIR": str(cache / "triton"),
            "USE_FLAX": "0", "USE_JAX": "0", "USE_TF": "0"}


def apply_environment():
    for key, value in environment().items():
        os.environ[key] = value
