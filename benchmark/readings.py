"""What the per-layer readers share: kernel time from the traced unit, the
whole step's operations, and the device's idle share."""

from __future__ import annotations

import re

from benchmark import counts


def kernel_ms(run, pattern: str) -> float | None:
    """Summed device ms of the traced unit's kernels whose name matches
    ``pattern`` (a regular expression searched in the name), or None."""
    if run.profile is None:
        return None
    rx = re.compile(pattern)
    hits = [k["ms"] for name, k in run.profile["kernels"].items() if rx.search(name)]
    return sum(hits) if hits else None


def idle_share(run) -> float | None:
    """Percent of the traced unit in which no operation ran on the device."""
    if run.profile is None or run.profile["window_s"] <= 0 or run.profile["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.profile["busy_s"] / run.profile["window_s"])


def mfu(run, gflop_per_unit: float, ops_per_s: float = counts.FP32_OPS_PER_S) -> float | None:
    """Percent of the peak rate that the window's operations come to, over
    the units that ran without the profiler."""
    plain = [s for i, (s, _) in enumerate(run.units) if i != run.traced_unit]
    if not plain:
        return None
    return 100.0 * gflop_per_unit * 1e9 * len(plain) / sum(plain) / ops_per_s


def share(bound_ms: float, ms: float | None) -> float | None:
    """Percent of a kernel's least time in its measured time."""
    return None if not ms else 100.0 * bound_ms / ms
