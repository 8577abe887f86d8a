#!/usr/bin/env python3
"""Readings the limits of ``correct`` are set from: for each seed, the
numbers a cell compares, from the program, from the control (the reference
in the next lower precision, put in the program's place) or from a fault
planted in the program, at the cell's own size and without a window.

    python3 benchmark/limits.py --workload <cell> --mode program --seeds 1,2,3 [--out FILE]

Modes are ``program`` and the driver's ``LIMIT_MODES``; where the driver
has no ``program`` mode of its own, a seed's program readings come from a
run of one unit. Prints one JSON object a seed, and with ``--out`` writes
them all to FILE.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out")
    args = p.parse_args(argv)
    from benchmark import harness

    harness.apply_environment()
    cell = harness.load_cell(args.workload)
    drv = harness.driver(cell["driver"])
    modes = set(getattr(drv, "LIMIT_MODES", ())) | {"program"}
    if args.mode not in modes:
        p.error(f"mode {args.mode!r} not among {sorted(modes)}")
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run = harness.Run(cell, seed, 0.0, False, args.device)
        if args.mode in getattr(drv, "LIMIT_MODES", ()):
            numbers = drv.limit_readings(run, args.mode)
        else:   # the program's own run: set-up, one unit, the check
            numbers = {name: value for name, value, _ in harness.measure(run, drv)["checks"]}
        row = {"seed": seed, "mode": args.mode, **numbers, **run.extra.get("notes", {}),
               "seconds": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
