"""Command-line entry points of the port (the ported subset of
weaklysuperviseddl_tpu/cli.py):

    python -m weaklysuperviseddl_tpu_torch weakly [--alternating] [--smoke] [--device cpu]
        [--checkpoint-dir DIR [--resume]] [--timings-out PATH]
        [--data.image_size 224 --seg.epochs 5 ...]
    python -m weaklysuperviseddl_tpu_torch supervised [--smoke] [--device cpu] [--seg.epochs 5 ...]
    python -m weaklysuperviseddl_tpu_torch ablations [--smoke] [--device cpu] [...]
    python -m weaklysuperviseddl_tpu_torch serve [--smoke] [--device cpu] [--port 8765]
        [--checkpoint PATH] [--no-int8 | --calib-dir DIR] [--calib-state PATH]
    python -m weaklysuperviseddl_tpu_torch client --url http://host:8765 --image photo.jpg
    python -m weaklysuperviseddl_tpu_torch basnet [--weights ./Weights/basnet.pth]
        [--num-images 10] [--dtype bfloat16] [--device cpu]

``weakly``, ``supervised``, ``ablations``, ``serve`` and ``basnet`` run on the
card unless ``--device cpu`` is given, with TF32 off for cuDNN convolutions
and matmuls, so float32 stays exact float32. ``weakly`` computes its models
in the config's compute dtypes, float32 by default: ``--classifier.dtype
bfloat16 --seg.dtype bfloat16`` runs the classifier and DeepLabV3 in
bfloat16 (float32 parameters, statistics and optimizer state; products
accumulate in float32; DeepLabV3's logits, the losses, the refinement and the
CRF stay float32), and ``basnet --dtype bfloat16`` runs BASNet so.
``supervised``, ``ablations`` and ``serve`` compute in float32 (int8 for
``serve``), as the JAX package's do. The training commands take dotted overrides onto
``config.ExperimentConfig`` (any depth: ``--alternating.refine.num_steps
10``) and print their result as one JSON line. ``weakly --checkpoint-dir``
snapshots every alternation; ``--resume`` continues from the latest snapshot
(and implies ``--alternating``); ``--timings-out`` writes the per-phase
record of the run. ``ablations`` runs the reference's grid with an untrained
classifier (``--smoke``: its first point, one repeat) and prints the last
summary. ``serve --checkpoint`` serves the DeepLabV3 weights of a seg state
file the port wrote (``utils/checkpoint.save_state`` of a seg state, or a
snapshot's ``state.pt``). ``serve`` quantizes the model to int8 by default,
as the JAX package does (``--no-int8``: float32): calibrated on the images of
``--calib-dir`` (read with PIL, imported only then) or, with a WARNING, on
synthetic ones, or loaded from ``--calib-state``, which is written after a
calibration; if the int8 masks agree with the float ones on under 0.99 of the
calibration batch's pixels, the float model serves, with a WARNING.
``--smoke`` skips int8. ``basnet`` is the reference's
``RunInference.py``: BASNet saliency on the first ``--num-images`` test
images (synthetic without Pet data), the weights of ``--weights`` when the
file exists, else seeded random ones, per-image and mean IoU and accuracy
against trimap == 1, and the maps as PNGs in ``./basnet_outputs`` (skipped,
with a WARNING, where PIL is not installed).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _config(args, parser, extra):
    """``--smoke`` or the default config, with the dotted overrides in ``extra``."""
    from weaklysuperviseddl_tpu_torch.config import ExperimentConfig, apply_overrides, smoke_config

    overrides = {}
    it = iter(extra)
    for token in it:
        if not token.startswith("--"):
            parser.error(f"{args.command}: unexpected argument {token!r}")
        value = next(it, None)
        if value is None:
            parser.error(f"{args.command}: {token} needs a value")
        overrides[token[2:]] = value
    return apply_overrides(smoke_config() if args.smoke else ExperimentConfig(), overrides)


def _device(args):
    """The run's device, with TF32 off: float32 computes in float32 and
    bfloat16 accumulates in float32."""
    import torch

    from weaklysuperviseddl_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return device


def _weakly(args, parser, extra) -> int:
    import dataclasses
    import time

    import torch

    from weaklysuperviseddl_tpu_torch.pipelines.weakly import (
        run_weakly_supervised,
        run_weakly_supervised_alternating,
    )
    from weaklysuperviseddl_tpu_torch.utils.profiling import Stopwatch

    cfg = _config(args, parser, extra)
    device = _device(args)
    sw = Stopwatch(device)
    t0 = time.perf_counter()
    if args.alternating or args.resume:
        result = run_weakly_supervised_alternating(cfg, checkpoint_dir=args.checkpoint_dir,
                                                   resume=args.resume, stopwatch=sw,
                                                   device=device)
    elif args.checkpoint_dir:
        parser.error("weakly: --checkpoint-dir snapshots the alternating loop; "
                     "add --alternating")
    else:
        result = run_weakly_supervised(cfg, stopwatch=sw, device=device)
    wall = time.perf_counter() - t0
    if args.timings_out:
        record = {
            "cmd": "python -m weaklysuperviseddl_tpu_torch weakly"
                   + (" --alternating" if args.alternating else "")
                   + (" --resume" if args.resume else ""),
            "config": dataclasses.asdict(cfg),
            "device": torch.cuda.get_device_name(device) if device.type == "cuda" else str(device),
            "wall_clock_s": round(wall, 2),
            "phases": {
                name: {
                    "seconds": round(sw.times[name], 3),
                    "calls": sw.counts[name],
                    "img_per_s": round(sw.rate(name), 2),
                    **({"first_call_s": round(sw.first_call_s(name), 3),
                        "marginal_img_per_s": round(sw.marginal_rate(name), 2)}
                       if sw.marginal_rate(name) is not None else {}),
                } for name in sw.times
            },
            "metrics": result.metrics,
        }
        with open(args.timings_out, "w") as f:
            json.dump(record, f, indent=1)
        sw.report()
    print(json.dumps(result.metrics))
    return 0


def _supervised(args, parser, extra) -> int:
    from weaklysuperviseddl_tpu_torch.pipelines.supervised import run_supervised_training

    cfg = _config(args, parser, extra)
    _, metrics = run_supervised_training(cfg, device=_device(args))
    print(json.dumps(metrics))
    return 0


def _ablations(args, parser, extra) -> int:
    from weaklysuperviseddl_tpu_torch.pipelines.ablations import (
        default_grid,
        run_ablation_experiment,
    )
    from weaklysuperviseddl_tpu_torch.pipelines.weakly import build_classifier

    cfg = _config(args, parser, extra)
    model = build_classifier(cfg, _device(args))
    grid = default_grid()[:1] if args.smoke else default_grid()
    results = run_ablation_experiment(grid, model, cfg, num_repeats=1 if args.smoke else 3)
    print(json.dumps(results[-1]))
    return 0


def serve_model(smoke: bool, checkpoint: str | None = None):
    """The served DeepLabV3 (2 classes; ResNet-50 at width 1, or ResNet-18 at
    width 0.25 with ``smoke``), on the CPU: the weights of ``checkpoint`` (a
    seg state file the port wrote), else seeded random ones. Raises
    ``ValueError`` when the checkpoint's weights do not fit."""
    import torch

    from weaklysuperviseddl_tpu_torch.models.deeplabv3 import DeepLabV3
    from weaklysuperviseddl_tpu_torch.models.resnet import init_weights
    from weaklysuperviseddl_tpu_torch.utils.checkpoint import load_model_weights

    model = DeepLabV3(num_classes=2, backbone_depth=18 if smoke else 50,
                      width_multiplier=0.25 if smoke else 1.0)
    if checkpoint:
        return load_model_weights(checkpoint, model)
    return init_weights(model, torch.Generator().manual_seed(0))


CALIB_EXTENSIONS = (".bmp", ".gif", ".jpeg", ".jpg", ".png", ".webp")


def _calibration_files(calib_dir: str, limit: int, parser) -> list[str]:
    """The first ``limit`` image files of ``calib_dir`` by name; none is a
    usage error."""
    files = sorted(f for f in os.listdir(calib_dir)
                   if os.path.isfile(os.path.join(calib_dir, f))
                   and os.path.splitext(f)[1].lower() in CALIB_EXTENSIONS)[:limit]
    if not files:
        parser.error(f"--calib-dir {calib_dir} contains no image files "
                     f"({'/'.join(sorted(CALIB_EXTENSIONS))})")
    return [os.path.join(calib_dir, f) for f in files]


def _calibration_images(files: list[str] | None, count: int, size: int):
    """uint8 [N,size,size,3]: ``files`` decoded and resized with PIL, or,
    without files, ``count`` synthetic test images (with a WARNING)."""
    import numpy as np

    if files:
        from PIL import Image

        return np.stack([np.asarray(Image.open(f).convert("RGB").resize((size, size)), np.uint8)
                         for f in files])
    from weaklysuperviseddl_tpu_torch.data.dataset import download_data

    print("WARNING: --int8 with no --calib-dir calibrates activation scales on SYNTHETIC "
          "images; pass --calib-dir with production-like images (or --no-int8) for a real "
          "deployment", flush=True)
    ds = download_data(None, split="test", synthetic_size=count, image_size=size)
    return np.stack([np.asarray(ds.images[i], np.uint8) for i in range(len(ds))])


def _quantize(pred, args, files: list[str] | None):
    """``pred.quantize`` on the calibration images (or ``--calib-state``),
    then the agreement gate: below 0.99 the float model serves."""
    import numpy as np

    calib = _calibration_images(files, args.max_batch, pred.size)
    reuse = args.calib_state and os.path.exists(args.calib_state)
    print(f"loading int8 calibration state from {args.calib_state}..." if reuse else
          f"calibrating int8 PTQ ({'dir' if files else 'synthetic'}, "
          f"{calib.shape[0]} images)...", flush=True)
    ref_masks = pred(calib)
    pred.quantize(calib, state_path=args.calib_state)
    agree = float(np.mean(pred(calib) == ref_masks))
    if agree < 0.99:
        pred.quantized = None
        print(f"WARNING: int8/float mask agreement {agree:.4f} < 0.99 on the calibration "
              "batch — falling back to the float serving program (check calibration "
              "coverage)", flush=True)
    else:
        print(f"int8/float mask agreement on calibration batch: {agree:.4f}", flush=True)


def wait_for_interrupt(server):  # pragma: no cover - long-running server
    """Serve until Ctrl-C, then stop the server."""
    import time

    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.stop()


def _serve(args, parser) -> int:
    import numpy as np

    from weaklysuperviseddl_tpu_torch.pipelines.serve import MaskClient, Predictor

    int8 = args.int8 and not args.smoke
    # a usage error before any model is built
    files = (_calibration_files(args.calib_dir, args.max_batch, parser)
             if args.int8 and args.calib_dir else None)
    device = _device(args)
    size = 48 if args.smoke else args.size
    try:
        model = serve_model(args.smoke, args.checkpoint)
    except (OSError, ValueError) as e:  # no such file, or not a seg state that fits
        parser.error(f"serve --checkpoint: {e}")
    pred = Predictor(model, size=size, max_batch=2 if args.smoke else args.max_batch,
                     packed=args.packed, device=device)
    if int8:
        _quantize(pred, args, files)
    pred.warmup(all_buckets=True)
    server = pred.serve_http(port=0 if args.smoke else args.port)
    print(f"serving uint8 [h,w,3] → {size}² masks on http://127.0.0.1:{server.port}/predict "
          f"({device}, {'int8' if pred.quantized is not None else 'float32'}; np.save bodies; "
          f"PNG/JPEG via Content-Type: image/*, PNG masks via Accept: image/png)", flush=True)
    if args.smoke:
        # self-request round trip through the shipped client, then exit
        try:
            mask = MaskClient(f"http://127.0.0.1:{server.port}", timeout=60.0).predict(
                np.zeros((size, size, 3), np.uint8))
        finally:
            server.stop()
        print(f"smoke round trip OK: mask {mask.shape} values {sorted(set(np.unique(mask)))}")
        return 0
    wait_for_interrupt(server)
    return 0


def _basnet(args) -> int:
    """The reference's ``RunInference.py`` main (the JAX package's
    ``compat/RunInference.py::main``) on the port's engine."""
    import importlib.util

    from weaklysuperviseddl_tpu_torch.data.dataset import download_data
    from weaklysuperviseddl_tpu_torch.pipelines.basnet_infer import run_inference

    device = _device(args)
    output_folder = "./basnet_outputs"
    if importlib.util.find_spec("PIL") is None:
        print("WARNING: PIL is not installed; the saliency PNGs are not written", flush=True)
        output_folder = None
    dataset = download_data(None, split="test", synthetic_size=args.num_images)
    run_inference(dataset, weights_path=args.weights, num_images=args.num_images,
                  output_folder=output_folder, device=device, dtype=args.dtype)
    return 0


def _client(args, parser) -> int:
    import urllib.error

    from weaklysuperviseddl_tpu_torch.pipelines.serve import MaskClient

    client = MaskClient(args.url, wire=args.wire)
    try:
        if args.stats:
            print(json.dumps({"healthz": client.healthz(), "stats": client.stats()}))
            return 0
        if not args.image:
            parser.error("client: pass --image PATH (or --stats)")
        mask = client.predict_file(args.image)
    except urllib.error.HTTPError as e:
        print(f"client: server error: HTTP {e.code} {e.reason} ({args.url})", file=sys.stderr)
        return 1
    except (urllib.error.URLError, OSError) as e:
        print(f"client: cannot reach {args.url}: {getattr(e, 'reason', e)}", file=sys.stderr)
        return 1
    import numpy as np
    from PIL import Image

    out = args.out or os.path.splitext(args.image)[0] + "_mask.png"
    Image.fromarray((mask > 0).astype(np.uint8) * 255, "L").convert("1").save(out)
    print(json.dumps({"out": out, "shape": list(mask.shape),
                      "fg_frac": round(float((mask > 0).mean()), 4)}))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="weaklysuperviseddl_tpu_torch")
    parser.add_argument("command", choices=["weakly", "supervised", "ablations", "serve",
                                            "client", "basnet"])
    parser.add_argument("--smoke", action="store_true",
                        help="weakly, supervised: config.smoke_config(); ablations: that "
                             "config, the grid's first point, one repeat; serve: depth 18, "
                             "width 0.25, 48², max_batch 2, one self-request, then exit")
    parser.add_argument("--device", default=None,
                        help="weakly, supervised, ablations, serve, basnet: torch device "
                             "(default: the card; 'cpu' to run on the CPU)")
    parser.add_argument("--alternating", action="store_true",
                        help="weakly: run the alternating train↔refine loop after the "
                             "initial cycle")
    parser.add_argument("--checkpoint-dir", default=None,
                        help="weakly --alternating: snapshot directory (train state and "
                             "mask store after every alternation)")
    parser.add_argument("--resume", action="store_true",
                        help="weakly: restore the latest snapshot in --checkpoint-dir and "
                             "continue the alternating loop")
    parser.add_argument("--timings-out", default=None,
                        help="weakly: write a per-phase seconds and img/s JSON record of "
                             "this run")
    parser.add_argument("--checkpoint", default=None,
                        help="serve: a seg state file the port wrote (save_state, or a "
                             "snapshot's state.pt); random init if omitted")
    parser.add_argument("--port", type=int, default=8765)
    parser.add_argument("--size", type=int, default=256)
    parser.add_argument("--max-batch", type=int, default=64)
    parser.add_argument("--packed", default=True, action=argparse.BooleanOptionalAction,
                        help="serve: bit-packed device→host mask readback (default on)")
    parser.add_argument("--int8", default=True, action=argparse.BooleanOptionalAction,
                        help="serve: int8 PTQ of the served model (default on; calibrates on "
                             "--calib-dir images or synthetic data; skipped with --smoke). "
                             "--no-int8 for float32")
    parser.add_argument("--calib-dir", default=None,
                        help="serve: directory of calibration PNGs/JPGs for --int8 (synthetic "
                             "calibration if omitted)")
    parser.add_argument("--calib-state", default=None,
                        help="serve: int8 calibration file (JSON, the JAX package's format): "
                             "loaded if it exists, written after calibration otherwise")
    parser.add_argument("--weights", default="./Weights/basnet.pth",
                        help="basnet: the reference's BASNet state dict (random init if the "
                             "file does not exist)")
    parser.add_argument("--num-images", type=int, default=10,
                        help="basnet: test images to evaluate")
    parser.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32",
                        help="basnet: the model's compute dtype (parameters stay float32)")
    parser.add_argument("--url", default="http://127.0.0.1:8765",
                        help="client: base URL of a running MaskServer")
    parser.add_argument("--image", default=None,
                        help="client: PNG/JPEG to send (bytes as is; the server decodes)")
    parser.add_argument("--out", default=None,
                        help="client: mask PNG output path (default: <image>_mask.png)")
    parser.add_argument("--wire", choices=["npy", "png"], default="npy",
                        help="client: response wire format")
    parser.add_argument("--stats", action="store_true",
                        help="client: print the server's /healthz and /stats JSON")
    args, extra = parser.parse_known_args(list(sys.argv[1:] if argv is None else argv))
    if args.command == "weakly":
        return _weakly(args, parser, extra)
    if args.command == "supervised":
        return _supervised(args, parser, extra)
    if args.command == "ablations":
        return _ablations(args, parser, extra)
    if extra:
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    if args.command == "serve":
        return _serve(args, parser)
    if args.command == "basnet":
        return _basnet(args)
    return _client(args, parser)


if __name__ == "__main__":
    sys.exit(main())
