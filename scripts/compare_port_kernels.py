#!/usr/bin/env python3
"""Times the PyTorch port's bilateral-filter (K3), refinement (K1),
window-loss (K4), connected-components (K2) and LayerCAM-fusion (K5)
kernels of this checkout against those of an earlier checkout, in turns on
one GPU.

    python3 scripts/compare_port_kernels.py --baseline DIR [--cases REGEX] [--out FILE]

DIR is an earlier checkout of the repository, from the one that added the
window-loss kernels on (for example ``git archive <commit> | tar -x -C
DIR``). Each checkout runs in processes of its own, through its own wrappers
(``ops/bilateral.py::gaussian_filter_cuda``, ``ops/refine.py::refine_cuda``
with ``plan``, ``ops/window.py::window_sum_cuda`` and
``window_sum_grad_cuda``, ``ops/cc.py::label_components_cuda``,
``ops/cam_fusion.py::cam_fusion_cuda``), with its kernels built from its own
``csrc/`` by its own ``ops/build.py``. The inputs are made once, by this
checkout, as ``chip_smoke.py``'s crf, refine, window, serve and cam_fusion
phases make them; K2 runs every family of ``masks/synthetic.py`` at
[64,256,256] (the served batch) and [32,224,224] (the pseudo-mask batch),
and the serve phase's argmax masks; K5 the full-width classifier's layer3
and layer4 activations and gradients at 224², batch 32. ``--cases`` keeps the cases whose name
the regular expression matches. The runs go baseline, current, current,
baseline: a case's ``ms`` is the mean of its two CUDA-event medians
(``chip_smoke.py::cuda_ms``), ``ms_runs`` both, and ``back_to_back_ms``,
``device_ms`` (the profiler's summed kernel time per call), ``kernel_ms``
(its split by kernel) and ``host_ms`` (the wrapper's host time per call,
``chip_smoke.py::host_ms``) come from the second run. The baseline's outputs
are held to the current ones: bilateral within 1e-4 relative, refinement
masks agreeing on >= 0.9999 of pixels with the loss within 1e-4, window
losses within 1e-5 of the largest value (``max_rel_diff_to_largest``, and
whether the bits are equal), labels equal, LayerCAM fusions within 1e-5
absolute. Prints one JSON line
per case (the first holds the card, torch and each checkout's ``-Xptxas -v``
summary), and writes them to FILE too if given.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
WORK = ROOT / "weaklysuperviseddl_tpu_torch" / "build" / "compare"  # in .gitignore
SOURCES = ("bilateral.cu", "refine.cu", "window.cu", "cc.cu", "cam_fusion.cu")
CC_SHAPES = {"64x256": (64, 256, 256), "32x224": (32, 224, 224)}
REFINE_CONFIGS = (  # name, inputs, keyword arguments, plans
    ("ncut_4x256_20_steps", "b4", {}, ("v1sym", "v1", "v2_aff")),
    ("ncut_8x256_10_steps", "b8", {"num_steps": 10}, ("v1sym",)),
    ("boundary_4x256_75_steps", "b4",
     {"loss": "boundary", "num_steps": 75, "lambda_boundary": 0.5, "sigma_space": 10.0},
     ("v1sym",)),
)


def smoke():
    """This checkout's ``chip_smoke.py`` (timers and input makers), loaded
    by path so that a worker's package stays the checkout it measures."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def make_inputs(path: Path) -> None:
    """The crf, refine, window, cc and cam_fusion phases' inputs, saved on
    the host."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from weaklysuperviseddl_tpu_torch.data.preprocess import normalize_images
    from weaklysuperviseddl_tpu_torch.data.synthetic import synthetic_pet_arrays
    from weaklysuperviseddl_tpu_torch.masks import synthetic
    from weaklysuperviseddl_tpu_torch.models.deeplabv3 import DeepLabV3
    from weaklysuperviseddl_tpu_torch.models.resnet import init_weights

    cs = smoke()
    fq, fk, v = cs.crf_path_inputs(32, 224, 2, seed=3)
    model = init_weights(DeepLabV3(2, 50, 1.0), torch.Generator().manual_seed(1)).eval().cuda()
    cs.centre_classifier_bias(model, cs._requests(np.random.default_rng(1), 4, (256, 256)), 256)
    b4 = cs.synthetic_path_batch(model, 4, 256, seed=5)
    b8 = cs.synthetic_path_batch(model, 8, 256, seed=6)
    images, _, _ = synthetic_pet_arrays(8, image_size=256, seed=11)
    x = normalize_images(torch.from_numpy(images).cuda()).contiguous()
    probs = torch.softmax(torch.randn((8, 256, 256, 2), device="cuda",
                                      generator=torch.Generator("cuda").manual_seed(0)), -1)
    masks = {f"cc_{name}_{tag}": (torch.from_numpy(synthetic.family(name, shape[0], shape[1:],
                                                                    seed=7)),)
             for tag, shape in CC_SHAPES.items() for name in synthetic.FAMILIES}
    served, rng, _ = cs.serve_model()
    cs._requests(rng, 2, (300, 400))  # the serve phase's card-against-CPU requests come first
    masks["cc_served_64x256"] = (cs.served_argmax(served, rng),)
    _, _, _, acts, grads = cs.cam_fusion_inputs()
    fusion = {f"cam_fusion_{layer}": (a, g)
              for layer, a, g in zip(("layer3", "layer4"), acts, grads)}
    cpu = lambda ts: tuple(t.cpu() for t in ts)  # noqa: E731
    torch.save({"bilateral": cpu((fq, fk, v)), "b4": cpu(b4), "b8": cpu(b8),
                "window": cpu((probs, x)), **{k: cpu(m) for k, m in masks.items()},
                **{k: cpu(t) for k, t in fusion.items()}}, path)


def worker(checkout: Path, inputs: Path, result: Path, pattern: str) -> None:
    """Every case whose name matches ``pattern`` through ``checkout``'s
    wrappers: outputs and timings."""
    sys.path.insert(0, str(checkout))
    import torch

    import weaklysuperviseddl_tpu_torch
    from weaklysuperviseddl_tpu_torch.ops import build
    from weaklysuperviseddl_tpu_torch.ops.bilateral import gaussian_filter_cuda
    from weaklysuperviseddl_tpu_torch.ops.cam_fusion import cam_fusion_cuda
    from weaklysuperviseddl_tpu_torch.ops.cc import label_components_cuda
    from weaklysuperviseddl_tpu_torch.ops.refine import refine_cuda
    from weaklysuperviseddl_tpu_torch.ops.window import window_sum_cuda, window_sum_grad_cuda

    package = Path(weaklysuperviseddl_tpu_torch.__file__).resolve().parent
    if package != checkout.resolve() / "weaklysuperviseddl_tpu_torch":
        raise RuntimeError(f"imported {package}, not the checkout {checkout}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cs = smoke()
    with ThreadPoolExecutor(len(SOURCES)) as pool:  # one nvcc per source, all at once
        libs = list(pool.map(build.build, SOURCES))
    ptxas = {lib.name: cs.ptxas_summary(lib.with_suffix(".log").read_text()) for lib in libs}
    data = {k: tuple(t.cuda() for t in ts) for k, ts in torch.load(inputs).items()}

    cases = {}  # name: (call, CUDA-event runs)
    fq, fk, v = data["bilateral"]
    for C, vals in ((2, v), (1, torch.ones_like(v[..., :1]))):
        cases[f"bilateral_C{C}"] = (lambda vals=vals: gaussian_filter_cuda(fq, fk, vals), 10)
    for name, batch, kw, plans in REFINE_CONFIGS:
        for plan in plans:
            cases[f"refine_{name}_{plan}"] = (
                lambda b=data[batch], kw=kw, plan=plan: refine_cuda(*b, plan=plan, **kw), 15)
    probs, x = data["window"]
    one = torch.ones((), device="cuda")
    cases["window_forward"] = (lambda: window_sum_cuda(probs, x, 0.1, None, 5), 25)
    cases["window_backward"] = (lambda: window_sum_grad_cuda(probs, x, 0.1, None, 5, one), 25)
    for name, tensors in data.items():
        if name.startswith("cc_"):
            cases[name] = (lambda masks=tensors[0]: label_components_cuda(masks), 25)
        if name.startswith("cam_fusion_"):
            cases[name] = (lambda ts=tensors: cam_fusion_cuda(*ts), 50)

    outputs, timings = {}, {}
    for name, (fn, runs) in cases.items():
        if not re.search(pattern, name):
            continue
        out = fn()
        torch.cuda.synchronize()
        outputs[name] = tuple(t.cpu() for t in out) if isinstance(out, tuple) else out.cpu()
        times = cs.kernel_ms(fn, runs=runs)
        kernels = {}
        for k, ms in cs.device_ms(fn, runs=5)[1].items():
            kernels[cs.short_name(k)] = kernels.get(cs.short_name(k), 0.0) + ms
        timings[name] = {**times, "kernel_ms": kernels, "host_ms": cs.host_ms(fn)}
    torch.save({"outputs": outputs, "timings": timings, "ptxas": ptxas}, result)


def agreement(name: str, got, want) -> dict:
    """The baseline's output against the current one, and whether it holds."""
    import torch

    if name.startswith("refine"):
        masks = float((got[0] == want[0]).float().mean())
        loss = abs(float(got[1]) - float(want[1])) / abs(float(want[1]))
        return {"mask_agreement": masks, "loss_rel_diff": loss,
                "ok": masks >= 0.9999 and loss <= 1e-4}
    if name.startswith("cc_"):
        equal = got.shape == want.shape and bool((got == want).all())
        return {"labels_equal": equal, "ok": equal}
    if name.startswith("bilateral"):
        rel = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
        return {"max_rel_diff": rel, "ok": rel <= 1e-4}
    if name.startswith("cam_fusion"):
        diff = float((got - want).abs().max())
        return {"max_abs_diff": diff, "ok": diff <= 1e-5}
    rel = float((got - want).abs().max() / want.abs().max())
    return {"max_rel_diff_to_largest": rel, "bits_equal": bool(torch.equal(got, want)),
            "ok": rel <= 1e-5}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, help="an earlier checkout of the repository")
    ap.add_argument("--cases", default="", help="time only the cases this regular expression "
                    "finds in their names")
    ap.add_argument("--out", type=Path, help="also write the JSON lines to this file")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--inputs", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--result", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is not None:
        worker(args.worker, args.inputs, args.result, args.cases)
        return 0
    if args.baseline is None:
        ap.error("--baseline DIR is required")
    import torch

    if not torch.cuda.is_available():
        print("compare_port_kernels: no CUDA device", file=sys.stderr)
        return 1
    WORK.mkdir(parents=True, exist_ok=True)
    inputs = WORK / "inputs.pt"
    make_inputs(inputs)
    checkouts = {"baseline": args.baseline.resolve(), "current": ROOT}
    runs = {"baseline": [], "current": []}
    for i, which in enumerate(("baseline", "current", "current", "baseline")):
        result = WORK / f"run{i}_{which}.pt"
        subprocess.run([sys.executable, str(Path(__file__).resolve()), "--worker",
                        str(checkouts[which]), "--inputs", str(inputs), "--result", str(result),
                        "--cases", args.cases],
                       check=True, timeout=1800)
        runs[which].append(torch.load(result))

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    rows = [{"card": smi, "torch": torch.__version__,
             "ptxas": {w: r[0]["ptxas"] for w, r in runs.items()}}]
    ok = True
    current = runs["current"][1]
    for name, want in current["outputs"].items():
        row = {"case": name, "variants": {}}
        for which, (first, second) in runs.items():
            ms = [first["timings"][name]["ms"], second["timings"][name]["ms"]]
            row["variants"][which] = {"ms": sum(ms) / 2, "ms_runs": ms,
                                      **{k: v for k, v in second["timings"][name].items()
                                         if k != "ms"}}
        row["baseline_vs_current"] = agreement(name, runs["baseline"][1]["outputs"][name], want)
        ok = ok and row["baseline_vs_current"]["ok"]
        rows.append(row)
    for row in rows:
        print(json.dumps(row), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    if not ok:
        print("compare_port_kernels: the baseline's outputs differ from the current ones",
              file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
