#!/usr/bin/env python3
"""Runs one cell of the benchmark of ``weaklysuperviseddl_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA card. Prints the
compared numbers and their limits as the last lines of standard error and
one JSON object as the last line of standard output. Exits 2, printing no
result, where there is no card or fewer cards than the cell needs, and 3
where ``jax``, ``jaxlib``, ``flax`` or the JAX package is loaded when the
window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "weaklysuperviseddl_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name, whole, is JAX's, jaxlib's,
    flax's or the JAX package's."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from benchmark import harness

    harness.apply_environment()
    import torch

    cell = harness.load_cell(args.workload)
    chips = int(cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"no result: the cell needs {chips} CUDA device(s), found {found}",
              file=sys.stderr)
        return 2
    result, run = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                 "cuda", T_START)
    loaded = forbidden_modules()
    if loaded:
        print(f"no result: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    print("unit seconds " + " ".join(f"{s:.4f}" for s, _ in run.units), file=sys.stderr)
    for key, value in result.get("notes", {}).items():
        print(f"note {key} {value!r}", file=sys.stderr)
    for name, c in result["compared"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"{name} {c['value']!r} limit {c['limit']!r} {ok}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
