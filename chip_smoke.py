#!/usr/bin/env python3
"""Drives the PyTorch port (weaklysuperviseddl_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each:
  1. device  - nvidia-smi name and power limit, torch's device name, TF32 flags
               (both set off: the serving path runs float32).
  2. build   - every CUDA source of the port, compiled with nvcc in parallel.
  3. cc      - the connected-components kernel against its plain PyTorch
               version on the card, on every mask family, at [64,256,256] and
               [3,250,333]: labels and keep-largest masks exactly equal, and
               two launches identical. Times with CUDA events (median of 25).
  4. serve   - DeepLabV3-ResNet50 at full width (2 classes, seeded random
               weights) through Predictor(size=256, max_batch=64, clean=True,
               packed=True): masks against the same weights on the CPU, a
               MaskServer answering MaskClient requests from 4 threads (each
               reply equal to a direct Predictor call on the batch it was
               served in), predict_many throughput, request latency, and a
               stage breakdown of one batch of 64. The kernel's launch count is
               reset just before this main path is driven and read just after.
Then the card's name and power limit, the kernels line, and the last line
``{"ok": true, "device": {...}}``. Any failed check raises: no result is
printed. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, runs: int = 25, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``runs`` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    return smi


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from weaklysuperviseddl_tpu_torch.ops import build

    sources = sorted(p.name for p in build.CSRC_DIR.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, all at once
        libs = list(pool.map(build.build, sources))
    seconds = time.perf_counter() - t0
    ptxas = {lib.name: [ln.strip() for ln in lib.with_suffix(".log").read_text().splitlines()
                        if "registers" in ln]
             for lib in libs}
    emit("build", sources=sources, seconds=round(seconds, 3), ptxas=ptxas)


def cc_bound_ms(shape) -> float:
    """Least time for the labelling: one uint8 mask read + one int32 label
    written per pixel, over HBM bandwidth."""
    return float(np.prod(shape)) * (1 + 4) / HBM_BYTES_PER_S * 1e3


def phase_cc():
    import torch

    from weaklysuperviseddl_tpu_torch.masks import synthetic
    from weaklysuperviseddl_tpu_torch.masks.components import keep_largest_batch, label_components
    from weaklysuperviseddl_tpu_torch.ops.cc import label_components_cuda

    results = []
    max_err = 0
    for shape in ((64, 256, 256), (3, 250, 333)):
        for name in synthetic.FAMILIES:
            masks = torch.from_numpy(synthetic.family(name, shape[0], shape[1:], seed=7)).cuda()
            got = label_components_cuda(masks)
            again = label_components_cuda(masks)
            want = label_components(masks)
            torch.cuda.synchronize()
            max_err = max(max_err, int((got.long() - want.long()).abs().max()))
            check(torch.equal(got, want), f"cc labels differ from plain: {name} {shape}")
            check(torch.equal(again, got), f"cc labels differ between launches: {name} {shape}")
            kl = keep_largest_batch(masks, backend="kernel")
            check(torch.equal(kl, keep_largest_batch(masks, backend="plain")),
                  f"keep-largest differs from plain: {name} {shape}")
            row = {"family": name, "shape": list(shape), "equal": True,
                   "fg_frac": round(float(masks.float().mean()), 4),
                   "components": int((got.view(shape[0], -1) == torch.arange(
                       shape[1] * shape[2], device="cuda")).sum())}
            if shape[0] == 64 and name in ("blobs", "speckle"):
                row["kernel_ms"] = cuda_ms(lambda: label_components_cuda(masks))
                row["plain_ms"] = cuda_ms(lambda: label_components(masks), runs=20, warmup=1)
                row["keep_largest_ms"] = cuda_ms(lambda: keep_largest_batch(masks))
                row["bound_ms"] = cc_bound_ms(shape)
            results.append(row)
    emit("cc", checks=results, max_abs_err=max_err, launches=label_components_cuda.launches,
         kernels=["cc_label"])
    return max_err


class RecordingPredictor:
    """Delegates to a Predictor and keeps each batch the server dispatches, so
    every reply can be checked against a direct call on the same batch."""

    def __init__(self, pred):
        self._pred = pred
        self.batches: list[np.ndarray] = []
        self._lock = threading.Lock()

    def __getattr__(self, name):
        return getattr(self._pred, name)

    def dispatch_async(self, images):
        with self._lock:
            self.batches.append(images.copy())
        return self._pred.dispatch_async(images)


def _requests(rng, n, hw):
    return (rng.uniform(0, 1, (n, *hw, 3)) * 255).astype(np.uint8)


def centre_classifier_bias(model, images, size: int):
    """Random weights put nearly every pixel in one class: move the class-1
    bias by the median logit margin on ``images``, so masks split about evenly
    into components and the cleanup has work to do."""
    import torch

    from weaklysuperviseddl_tpu_torch.data.preprocess import normalize_images, preprocess_images

    dev = next(model.parameters()).device
    with torch.no_grad():
        x = torch.from_numpy(images).to(dev).permute(0, 3, 1, 2)
        logits = model(normalize_images(preprocess_images(x, size), channel_dim=1))
        margin = float((logits[:, 1] - logits[:, 0]).median())
        model.classifier[4].bias[1] -= margin
    return margin


def conv_gflop(model, x) -> float:
    """GFLOP the model's convolutions execute on ``x`` (2 per multiply-add,
    padding taps included, as a dense dilated convolution runs them)."""
    import torch

    total = [0]

    def hook(m, inputs, out):
        kh, kw = m.kernel_size
        total[0] += 2 * out.numel() * (m.in_channels // m.groups) * kh * kw

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, torch.nn.Conv2d)]
    try:
        with torch.inference_mode():
            model(x)
    finally:
        for h in handles:
            h.remove()
    return total[0] / 1e9


def stage_breakdown(model, images_dev, size: int) -> dict:
    """Device ms of each stage of the serving forward at one batch shape, and
    the model's time per image at smaller batches."""
    import torch

    from weaklysuperviseddl_tpu_torch.data.preprocess import preprocess_images
    from weaklysuperviseddl_tpu_torch.masks.components import keep_largest_batch
    from weaklysuperviseddl_tpu_torch.pipelines.serve import pack_binary_masks
    from weaklysuperviseddl_tpu_torch.train.segmentation import _normalize_images

    with torch.inference_mode():
        x = _normalize_images(preprocess_images(images_dev.permute(0, 3, 1, 2), size), 1)
        logits = model(x)
        masks = logits.argmax(dim=1).to(torch.uint8)
        clean = keep_largest_batch(masks)
        out = {
            "batch": x.shape[0],
            "preprocess_ms": cuda_ms(lambda: _normalize_images(
                preprocess_images(images_dev.permute(0, 3, 1, 2), size), 1), runs=10),
            "model_ms": cuda_ms(lambda: model(x), runs=5, warmup=1),
            "argmax_ms": cuda_ms(lambda: logits.argmax(dim=1).to(torch.uint8), runs=10),
            "keep_largest_ms": cuda_ms(lambda: keep_largest_batch(masks), runs=10),
            "pack_ms": cuda_ms(lambda: pack_binary_masks(clean), runs=10),
            "model_gflop": conv_gflop(model, x),
        }
        out["model_tflop_per_s"] = out["model_gflop"] / out["model_ms"]
        out["model_ms_per_image_by_batch"] = {
            b: cuda_ms(lambda: model(x[:b]), runs=5, warmup=1) / b for b in (1, 4, 16)}
    return out


def phase_serve():
    import copy

    import torch

    from weaklysuperviseddl_tpu_torch.masks.components import keep_largest_batch
    from weaklysuperviseddl_tpu_torch.models.deeplabv3 import DeepLabV3
    from weaklysuperviseddl_tpu_torch.models.resnet import init_weights
    from weaklysuperviseddl_tpu_torch.ops.cc import label_components_cuda
    from weaklysuperviseddl_tpu_torch.pipelines.serve import MaskClient, MaskServer, Predictor

    size, max_batch = 256, 64
    rng = np.random.default_rng(0)
    model = init_weights(DeepLabV3(2, 50, 1.0), torch.Generator().manual_seed(0)).eval().cuda()
    margin = centre_classifier_bias(model, _requests(rng, 8, (size, size)), size)
    cpu_model = copy.deepcopy(model).cpu()

    t0 = time.perf_counter()
    pred = Predictor(model, size=size, max_batch=max_batch, clean=True, packed=True,
                     device="cuda").warmup(all_buckets=True)
    warmup_s = time.perf_counter() - t0

    # the card against the CPU, same weights; requests of another size (resize + antialias)
    two = _requests(rng, 2, (300, 400))
    gpu_masks = pred(two)
    cpu_masks = Predictor(cpu_model, size=size, max_batch=2, clean=True, packed=True,
                          device="cpu")(two)
    agree = float((gpu_masks == cpu_masks).mean())
    check(gpu_masks.shape == (2, size, size) and set(np.unique(gpu_masks)) <= {0, 1},
          "served masks are not binary [2,256,256]")
    check(agree >= 0.995, f"card/CPU mask agreement {agree} < 0.995")
    # keep-largest on the card's own argmax: kernel against the plain version
    raw = Predictor(model, size=size, max_batch=max_batch, device="cuda")(
        _requests(rng, max_batch, (size, size)))
    raw_dev = torch.from_numpy(raw).cuda()
    cleaned = keep_largest_batch(raw_dev, backend="kernel")
    check(torch.equal(cleaned, keep_largest_batch(raw_dev, backend="plain")),
          "keep-largest on the served argmax differs from plain")
    fg_raw, fg_clean = float(raw.mean()), float(cleaned.float().mean())

    # ---- the main path: counts from 0, server + throughput, counts read after ----
    label_components_cuda.launches = 0
    recorder = RecordingPredictor(pred)
    server = MaskServer(recorder, max_wait_ms=5.0).start()
    base = f"http://127.0.0.1:{server.port}"
    n_threads, per_thread = 4, 32
    reqs = _requests(rng, n_threads * per_thread, (size, size))
    replies, latencies, errors = {}, [], []

    def client(t):
        c = MaskClient(base, timeout=120.0)
        try:
            for i in range(t, len(reqs), n_threads):
                s = time.perf_counter()
                replies[i] = c.predict(reqs[i])
                latencies.append(time.perf_counter() - s)
        except Exception as e:  # reported below; the phase fails
            errors.append(repr(e))
        finally:
            c.close()

    try:
        threads = [threading.Thread(target=client, args=(t,)) for t in range(n_threads)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        serve_s = time.perf_counter() - t0
        stats = MaskClient(base).stats()
    finally:
        server.stop()
    check(not errors and len(replies) == len(reqs), f"client errors {errors[:3]}")

    many = _requests(rng, 256, (size, size))
    pred.predict_many(many[:max_batch])  # warm
    many_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = pred.predict_many(many)
        many_s.append(time.perf_counter() - t0)
    launches = label_components_cuda.launches
    check(out.shape == (len(many), size, size), "predict_many shape")
    check(launches > 0, "the main path never launched the cc kernel")

    # every reply equals a direct Predictor call on the batch it was served in
    direct = {}
    for batch in recorder.batches:
        for img, mask in zip(batch, pred(batch)):
            direct[img.tobytes()] = mask
    for i, img in enumerate(reqs):
        check(np.array_equal(replies[i], direct[img.tobytes()]),
              f"served reply {i} differs from a direct Predictor call")

    lat_ms = np.asarray(latencies) * 1e3
    breakdown = stage_breakdown(model, torch.from_numpy(many[:max_batch]).cuda(), size)
    emit("serve", model="DeepLabV3-ResNet50 os8 width 1.0, 2 classes, random init (seed 0)",
         size=size, max_batch=max_batch, clean=True, packed=True,
         bias_shift=margin, warmup_all_buckets_s=round(warmup_s, 3),
         card_cpu_agreement=agree, keep_largest_equal_plain=True,
         fg_frac_argmax=fg_raw, fg_frac_clean=fg_clean,
         requests=len(reqs), client_threads=n_threads, replies_equal_direct=True,
         dispatches=len(recorder.batches),
         mean_dispatch_size=stats["mean_dispatch_size"],
         request_p50_ms=float(np.percentile(lat_ms, 50)),
         request_p99_ms=float(np.percentile(lat_ms, 99)),
         server_img_per_s=len(reqs) / serve_s,
         predict_many_img_per_s=[len(many) / s for s in many_s],
         predict_many_images=len(many),
         stage_ms=breakdown,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
         cc_launches_main_path=launches)
    return launches, raw_dev


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one", file=sys.stderr)
        return 1
    import weaklysuperviseddl_tpu_torch  # noqa: F401  (fails here, before any output, outside a checkout)

    smi = phase_device()
    phase_build()
    max_err = phase_cc()
    launches, served_masks = phase_serve()

    from weaklysuperviseddl_tpu_torch.masks.components import label_components
    from weaklysuperviseddl_tpu_torch.ops.cc import label_components_cuda

    # the kernel on the masks the main path gave it: the served argmax [64,256,256]
    shape = tuple(served_masks.shape)
    kernel_line = {"kernels": [{
        "name": "cc_label",
        "route": "cuda",
        "source": "weaklysuperviseddl_tpu_torch/csrc/cc.cu",
        "replaces": "weaklysuperviseddl_tpu/ops/pallas_cc.py:29",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": cuda_ms(lambda: label_components_cuda(served_masks)),
        "plain_ms": cuda_ms(lambda: label_components(served_masks), runs=20, warmup=1),
        "bound_ms": cc_bound_ms(shape),
        "bound_by": "bytes",
        "library_ms": None,  # no single PyTorch call labels connected components
        "shape": list(shape),
    }]}
    print(smi, flush=True)
    print(json.dumps(kernel_line), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
