#!/usr/bin/env python3
"""Where the connected-components kernel's one-block image plan spends its
time, phase by phase, on one GPU.

    python3 scripts/probe_cc_phases.py [--out FILE]

Builds ``weaklysuperviseddl_tpu_torch/csrc/cc.cu`` a second time with
``-DCC_PROBE`` (into the ignored build directory), which makes every block
of ``cc_image`` record its clock at the start and at the end of each of its
seven phases (planes, run heads, unions, roots and offers, head labels, node
labels, label stores). For every family of ``masks/synthetic.py`` at
[64,256,256] (the served batch), [32,224,224] (the pseudo-mask batch),
[4,256,256] and [1,256,256] it prints one JSON line: the call's CUDA-event
time through ``ops/cc.py::label_components_cuda`` (the build without the
probe; ``chip_smoke.py::cuda_ms``), the probe build's labels held to the
wrapper's, and the slowest block's cycles by phase and their shares. The
first line holds the card and the probe build's ``-Xptxas -v`` summary.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
PHASES = ("planes", "run_heads", "unions", "roots_offers", "head_labels", "node_labels",
          "label_stores")
SHAPES = ((64, 256, 256), (32, 224, 224), (4, 256, 256), (1, 256, 256))
PROBE_BLOCKS, PROBE_STAMPS = 256, 8  # csrc/cc.cu under CC_PROBE


def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def build_probe() -> tuple[Path, str]:
    from weaklysuperviseddl_tpu_torch.ops import build

    out_dir = build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libcc_probe.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-DCC_PROBE", "-o", str(lib),
           str(build.CSRC_DIR / "cc.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
    return lib, proc.stdout + proc.stderr


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, help="also write the JSON lines to this file")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("probe_cc_phases: no CUDA device", file=sys.stderr)
        return 1
    from weaklysuperviseddl_tpu_torch.masks import synthetic
    from weaklysuperviseddl_tpu_torch.ops.cc import PLANS, label_components_cuda, plan_for

    cs = smoke()
    path, log = build_probe()
    lib = ctypes.CDLL(str(path))
    lib.wsdl_cc_label.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.wsdl_cc_label.restype = ctypes.c_int
    lib.wsdl_cc_probe.argtypes = [ctypes.c_void_p]
    lib.wsdl_cc_probe.restype = ctypes.c_int
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    rows = [{"card": smi, "torch": torch.__version__, "ptxas": cs.ptxas_summary(log)}]
    ok = True
    for shape in SHAPES:
        plan = plan_for(*shape[1:])
        if plan != "image":
            raise RuntimeError(f"{shape} takes the {plan} plan, not the image plan")
        for name in synthetic.FAMILIES:
            masks = torch.from_numpy(synthetic.family(name, shape[0], shape[1:], seed=7)).cuda()
            want = label_components_cuda(masks)
            got = torch.empty_like(want)
            err = lib.wsdl_cc_label(masks.data_ptr(), got.data_ptr(), *shape,
                                    PLANS.index("image"), torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"probe launch failed with cudaError {err}")
            torch.cuda.synchronize()
            clocks = (ctypes.c_longlong * (PROBE_BLOCKS * PROBE_STAMPS))()
            if lib.wsdl_cc_probe(clocks) != 0:
                raise RuntimeError("reading the probe failed")
            stamps = np.asarray(clocks[:], dtype=np.int64).reshape(PROBE_BLOCKS, PROBE_STAMPS)
            cycles = np.diff(stamps[:min(shape[0], PROBE_BLOCKS)], axis=1)
            slowest = cycles[int(np.argmax(cycles.sum(axis=1)))]
            equal = bool(torch.equal(got, want))
            ok = ok and equal
            rows.append({
                "family": name, "shape": list(shape), "labels_equal": equal,
                "ms": cs.cuda_ms(lambda m=masks: label_components_cuda(m)),
                "slowest_block_cycles": int(slowest.sum()),
                "cycles_by_phase": dict(zip(PHASES, slowest.tolist())),
                "share_by_phase": {p: round(float(c) / float(slowest.sum()), 4)
                                   for p, c in zip(PHASES, slowest)},
            })
    for row in rows:
        print(json.dumps(row), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    if not ok:
        print("probe_cc_phases: the probe build's labels differ from the wrapper's", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
