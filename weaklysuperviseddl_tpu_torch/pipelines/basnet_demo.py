"""BASNet trained from random weights and checked through the inference
engine (port of the JAX package's ``scripts/train_basnet_demo.py``).

The reference uses BASNet only as a pretrained engine (``basnet.pth``); this
trains the port with the recipe that produced those weights (the hybrid loss
over all 8 side outputs, ``train/basnet.py``; Adam 3e-4, clip 1.0, cosine to
1e-5, since the paper's 1e-3 diverges from random weights) on a train split,
and pushes the weights through the same engine the reference's protocol uses
(``pipelines/basnet_infer.run_inference``) on the train split and on a
disjoint held-out split, before, during (every ``--eval-every`` epochs) and
after training. The record keeps both IoU trajectories, so the
generalisation gap is stated.

    python -m weaklysuperviseddl_tpu_torch.pipelines.basnet_demo \\
        [--images 200] [--holdout 50] [--epochs 120] [--device cpu] [--out PATH]

Writes ``--out`` (default ``E2E_BASNET_TRAIN_TORCH.json``) with the JAX
record's keys; ``protocol.device`` is ``nvidia-smi``'s name and power limit
on the card. The held-out maps of the trained model go to
``basnet_outputs_trained_torch/`` as PNGs where PIL is installed.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import time

import numpy as np
import torch

from weaklysuperviseddl_tpu_torch.data.dataset import download_data
from weaklysuperviseddl_tpu_torch.data.preprocess import normalize_images, preprocess_batch
from weaklysuperviseddl_tpu_torch.device import resolve_device
from weaklysuperviseddl_tpu_torch.pipelines.basnet_infer import build_basnet, run_inference
from weaklysuperviseddl_tpu_torch.train.basnet import train_basnet
from weaklysuperviseddl_tpu_torch.utils.profiling import Stopwatch


def device_name(device: torch.device) -> str:
    """``nvidia-smi``'s name and power limit of the card (torch's name where
    nvidia-smi cannot be run), or the device's type."""
    if device.type != "cuda":
        return str(device)
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
             f"--id={device.index or 0}"], capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return torch.cuda.get_device_name(device)
    return out.stdout.strip() or torch.cuda.get_device_name(device)


def training_arrays(dataset, n: int, batch_size: int, image_size: int, device):
    """The first ``n`` images, padded to a multiple of ``batch_size`` by
    repeating from the start, preprocessed as the engine does (resize,
    ImageNet normalisation) on ``device``: ([N,S,S,3] float32, [N,S,S]
    targets trimap == 1)."""
    n_pad = -(-n // batch_size) * batch_size
    sel = np.concatenate([np.arange(n), np.arange(n_pad - n) % n])
    images = torch.from_numpy(np.stack([dataset.images[i] for i in sel])).to(device)
    trimaps = torch.from_numpy(np.stack([dataset.trimaps[i] for i in sel])).to(device)
    x, tri = preprocess_batch(images, trimaps, size=image_size, shift_mask_labels=False)
    return normalize_images(x), (tri == 1).float()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="weaklysuperviseddl_tpu_torch.pipelines.basnet_demo")
    ap.add_argument("--images", type=int, default=200, help="train-set size")
    ap.add_argument("--holdout", type=int, default=50, help="held-out size")
    ap.add_argument("--epochs", type=int, default=120)
    ap.add_argument("--eval-every", type=int, default=20,
                    help="record train/held-out engine IoU every N epochs")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--image-size", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--clip-norm", type=float, default=1.0)
    ap.add_argument("--lr-end", type=float, default=1e-5)
    ap.add_argument("--pet-root", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run on the CPU)")
    ap.add_argument("--out", default="E2E_BASNET_TRAIN_TORCH.json")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sw = Stopwatch(device)
    t0 = time.perf_counter()
    print(f"device: {device_name(device)}", flush=True)

    # disjoint splits: the synthetic generator seeds each split apart
    train_ds = download_data(args.pet_root, split="trainval", synthetic_size=args.images,
                             image_size=args.image_size, seed=0)
    held_ds = download_data(args.pet_root, split="test", synthetic_size=args.holdout,
                            image_size=args.image_size, seed=0)
    model = build_basnet(weights_path=None, device=device)

    def engine_iou(ds, n, out_folder=None):
        _, iou, acc = run_inference(ds, model=model, num_images=n, output_folder=out_folder,
                                    log=lambda *a: None)
        return iou, acc

    # the train-side trajectory uses a fixed subset so its cost stays flat
    n_train_eval = min(args.images, args.holdout)
    with sw.phase("eval_random_init", images=n_train_eval + args.holdout):
        iou0_tr, _ = engine_iou(train_ds, n_train_eval)
        iou0_ho, acc0_ho = engine_iou(held_ds, args.holdout)
    print(f"random-init engine IoU train {iou0_tr:.4f} held-out {iou0_ho:.4f}", flush=True)

    x, targets = training_arrays(train_ds, args.images, args.batch_size, args.image_size,
                                 device)
    n_pad = x.shape[0]
    trajectory = []

    def eval_hook(_model, epoch):
        # inside the train phase's wall clock: timed apart, so the train rate
        # can be given net of evaluation
        with sw.phase("eval_trajectory", images=n_train_eval + args.holdout):
            iou_tr, _ = engine_iou(train_ds, n_train_eval)
            iou_ho, _ = engine_iou(held_ds, args.holdout)
        trajectory.append({"epoch": epoch, "train_iou": round(iou_tr, 4),
                           "held_out_iou": round(iou_ho, 4)})
        print(f"  epoch {epoch}: engine IoU train {iou_tr:.4f} held-out {iou_ho:.4f}",
              flush=True)

    with sw.phase("train", images=n_pad * args.epochs):
        _, history = train_basnet(
            model, x, targets, epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
            clip_norm=args.clip_norm, lr_end=args.lr_end, eval_hook=eval_hook,
            eval_every=args.eval_every, log=lambda s: print(s, flush=True))

    png_dir = "basnet_outputs_trained_torch" if importlib.util.find_spec("PIL") else None
    with sw.phase("eval_trained", images=n_train_eval + args.holdout):
        iou1_tr, _ = engine_iou(train_ds, n_train_eval)
        iou1_ho, acc1_ho = engine_iou(held_ds, args.holdout, out_folder=png_dir)
    print(f"trained engine IoU train {iou1_tr:.4f} held-out {iou1_ho:.4f} "
          f"(gap {iou1_tr - iou1_ho:+.4f})", flush=True)

    record = {
        "protocol": {
            "train_images": args.images, "held_out_images": args.holdout,
            "epochs": args.epochs, "batch_size": args.batch_size,
            "image_size": args.image_size, "lr": args.lr,
            "clip_norm": args.clip_norm, "lr_end": args.lr_end,
            "loss": "hybrid bce+ssim+iou × 8 side outputs",
            "device": device_name(device),
            "torch": torch.__version__,
        },
        "random_init": {"train_iou": round(iou0_tr, 4), "held_out_iou": round(iou0_ho, 4),
                        "held_out_acc": round(acc0_ho, 4)},
        "trained": {"train_iou": round(iou1_tr, 4), "held_out_iou": round(iou1_ho, 4),
                    "held_out_acc": round(acc1_ho, 4),
                    "generalization_gap": round(iou1_tr - iou1_ho, 4)},
        "iou_trajectory": trajectory,
        "loss_first_epoch": round(history[0], 4),
        "loss_last_epoch": round(history[-1], 4),
        "loss_every_10": [round(v, 4) for v in history[::10]],
        "wall_clock_s": round(time.perf_counter() - t0, 2),
        "phases": {n: {"seconds": round(sw.times[n], 3), "img_per_s": round(sw.rate(n), 2)}
                   for n in sw.times},
    }
    if device.type == "cuda":
        record["peak_memory_gb"] = round(torch.cuda.max_memory_allocated(device) / 2**30, 3)
    # the eval_trajectory hooks run inside the train phase's wall clock
    eval_s = sw.times.get("eval_trajectory", 0.0)
    if eval_s and sw.times["train"] > eval_s:
        net = sw.times["train"] - eval_s
        record["phases"]["train"] = {
            "seconds": round(net, 3), "img_per_s": round(n_pad * args.epochs / net, 2),
            "note": "net of the eval_trajectory hooks that run mid-phase",
        }
    sw.report()
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    print(f"wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
