#!/usr/bin/env python3
"""Times the LayerCAM-fusion kernel (K5, ``csrc/cam_fusion.cu``) at every
cluster size on one GPU, at the full-width classifier's layer3 and layer4
activations and gradients (224², batch 32, as ``chip_smoke.py``'s
cam_fusion phase makes them):

    python3 scripts/probe_cam_clusters.py [--out FILE]

For each layer and each S in ``ops/cam_fusion.py::CLUSTER_SIZES`` (the
wrapper's own choice set aside), one JSON line: the output's largest
difference to the plain version (each must be within 1e-5), the clusters the
card holds at once, and ``chip_smoke.py::kernel_ms`` and ``host_ms``. The
first line holds the card's name and power limit and the wrapper's choice.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, help="also write the JSON lines to this file")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("probe_cam_clusters: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from weaklysuperviseddl_tpu_torch.ops import cam_fusion

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    torch.backends.cudnn.allow_tf32 = False
    _, _, _, acts, grads = cs.cam_fusion_inputs()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    sms = cam_fusion.sm_count(acts[0].device)
    rows = [{"card": smi, "sms": sms,
             "chosen": {layer: cam_fusion.cluster_size(a.shape[0], a.shape[1], sms)
                        for layer, a in zip(("layer3", "layer4"), acts)}}]
    choose = cam_fusion.cluster_size
    ok = True
    try:
        for layer, a, g in zip(("layer3", "layer4"), acts, grads):
            want = cam_fusion.cam_fusion_plain(a, g)
            B, C, h, w = a.shape
            for S in cam_fusion.CLUSTER_SIZES:
                cam_fusion.cluster_size = lambda B, C, sms, S=S: S
                fn = lambda: cam_fusion.cam_fusion_cuda(a, g)  # noqa: E731
                err = float((fn() - want).abs().max())
                ok = ok and err <= 1e-5
                rows.append({"layer": layer, "shape": [B, C, h, w], "cluster_size": S,
                             "max_active_clusters": cam_fusion.max_active_clusters(
                                 C, h * w, S, (h * w) % 4 == 0),
                             "max_abs_err": err, **cs.kernel_ms(fn, runs=50, warmup=5),
                             "host_ms": cs.host_ms(fn, runs=50)})
    finally:
        cam_fusion.cluster_size = choose
    for row in rows:
        print(json.dumps(row), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    if not ok:
        print("probe_cam_clusters: a cluster size's output differs from plain", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
