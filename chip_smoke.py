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
  5. refine  - the refinement kernel against its plain PyTorch version on the
               card: at [2,16,16], [1,20,24] and [2,37,53], both losses, C=2 and
               3, windows 5 and 3, lr 1e-2 and 0.2 (where masks move), masks
               exactly equal and loss rtol 1e-4; at the path's shape
               [4,256,256], C=2, 20 steps, with S from a DeepLabV3-ResNet50
               forward on synthetic pets, mask agreement >= 0.9999 and loss
               rtol 1e-4 at lr 1e-2 and, with random S, at lr 0.1 (masks move);
               with the model's S at lr 0.1, mismatches only where S is within
               0.05 of the threshold; two launches bit-identical. Times with
               CUDA events beside the bound.
  6. weakly  - the training main path through run_weakly_supervised_alternating
               at full width: ResNet-50 CAM classifier (37 classes, 224², layer4
               dilated) → LayerCAM → pseudo-masks → DeepLabV3-ResNet50 os8
               (256², batch 4) ↔ refinement (256², C=2, window 5, 20 steps,
               ncut). Cut in depth only (listed in the line). Both kernels'
               launch counts are reset just before and read just after; then one
               refinement-sweep batch on the card against the same weights on
               the CPU, at the path's lr and at lr 0.1 (mask agreement >= 0.995),
               and a device-time breakdown of one training step.
  7. crf     - the bilateral-filter kernel against its plain PyTorch version on
               the card: ragged 531x187 with d 5 and C 1, 2, 3; d 20 with C 128;
               a batch of 3 with different features per image (rtol 1e-4, atol
               1e-5); the reference's magnitudes against a float64 sum (max
               error < 1e-3 of the largest output); the path's shape
               [32,50176]x[32,12544], d 5, C 2, against the plain version on 2
               of the 32 images (rtol 1e-4) and two launches bit-identical.
               Times with CUDA events beside the bound.
  8. cam_fusion - the LayerCAM-fusion kernel against its plain version at the
               full-width classifier's layer3 and layer4 shapes (its own
               activations and gradients on synthetic pets) and at a ragged
               [2,130,7,9] (atol 1e-5); then the path: layercam(fusion="pallas")
               against fusion="xla" at 224², batch 32 (atol 1e-5), the kernel's
               count reset just before and read just after. Times beside the
               bound.
  9. weakly_crf - the CRF pseudo-mask path through
               run_weakly_supervised_alternating at full width: as weakly, with
               mask.use_crf (the reference's parameters: subsampled, stride 2, 5
               iterations, sigma 1/50/5, compat 2/10) and seg.loss_fn
               lovasz_softmax; every kernel's count reset just before and read
               just after (the bilateral kernel must launch ceil(n/32)*6 times);
               then on 32 train images with the run's classifier: CRF masks from
               the kernel against the plain filter on the card (>= 0.999), the
               card against the CPU on 2 images (>= 0.999), and subsampled
               against attention per image (mean >= 0.99).
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
FP32_OPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores, NVIDIA data sheet
# the reference's CRF parameters (AlternatingDirectionCutLoss.py:183-204) and
# the config's default backend
CRF_REFERENCE = dict(gauss_sxy=1.0, gauss_compat=2.0, bilat_sxy=50.0, bilat_srgb=5.0,
                     bilat_compat=10.0, n_iters=5, bilat_backend="subsampled", key_stride=2)


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


def refine_work(B: int, H: int, W: int, C: int, window: int, steps: int, loss: str):
    """(bytes, fp32 operations) the refinement needs at the least, from its
    shapes. Bytes: S, the image and the int32 mask read once, the uint8 mask
    written once. Operations, each exp/log/div/sqrt counted as one:
      once per pixel: the K colour affinities (3 sub, 3 mul, 2 add, the
        exponent's mul and sub, exp: 11 each; they depend on the image only)
        and S·log S (3 per class);
      per pixel and step: softmax(X) (5C-2) and, for ncut, softmax(q) (5C-2);
        KL (5 per class); per offset and class d, a·d, a·d·d, the W sum and
        the gradient's centre and mirror sums (6); the VJPs and the KL
        gradient (13 per class, +4 per class for ncut); Adam (14 per class)."""
    K = window * window - 1
    px = B * H * W
    softmaxes = (5 * C - 2) * (2 if loss == "ncut" else 1)
    per_step = softmaxes + 5 * C + 6 * K * C + (13 + (4 if loss == "ncut" else 0)) * C + 14 * C
    ops = px * (11 * K + 3 * C + steps * per_step)
    nbytes = px * (4 * C + 4 * 3 + 4 + 1)
    return nbytes, ops


def refine_bound(shape, C: int, window: int, steps: int, loss: str):
    """(least ms, what binds it, operations) of the refinement at [B,H,W]."""
    nbytes, ops = refine_work(*shape, C, window, steps, loss)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations"), ops


def synthetic_path_batch(model, n: int, size: int, seed: int):
    """S [n,size,size,2] from a DeepLabV3 forward, normalised images and
    initial masks (the pets' trimap foreground) for the refinement at the
    path's shape, all on the model's device."""
    import torch

    from weaklysuperviseddl_tpu_torch.data.preprocess import normalize_images
    from weaklysuperviseddl_tpu_torch.data.synthetic import synthetic_pet_arrays

    dev = next(model.parameters()).device
    images, _, trimaps = synthetic_pet_arrays(n, image_size=size, seed=seed)
    x = normalize_images(torch.from_numpy(images).to(dev))
    with torch.no_grad():
        S = torch.softmax(model.logits_nhwc(x), dim=-1).contiguous()
    masks = torch.from_numpy((trimaps == 1).astype(np.int32)).to(dev)
    return S, x.contiguous(), masks


def phase_refine():
    import torch

    from weaklysuperviseddl_tpu_torch.models.deeplabv3 import DeepLabV3
    from weaklysuperviseddl_tpu_torch.models.resnet import init_weights
    from weaklysuperviseddl_tpu_torch.ops.refine import refine_cuda, refine_plain

    # lr 1e-2 (the path's): a logit moves about lr per Adam step, so in 8 steps
    # no pixel can leave its one-hot start; at lr 0.2 many cross the threshold
    checks, max_err = [], 0.0
    for shape in ((2, 16, 16), (1, 20, 24), (2, 37, 53)):
        for loss in ("ncut", "boundary"):
            for C in (2, 3):
                for window in (5, 3):
                    for lr in (1e-2, 0.2):
                        rng = np.random.default_rng(len(checks))
                        S = rng.uniform(0.1, 1, (*shape, C)).astype(np.float32)
                        S /= S.sum(-1, keepdims=True)
                        args = [torch.from_numpy(a).cuda() for a in (
                            S, rng.uniform(-1, 1, (*shape, 3)).astype(np.float32),
                            rng.integers(0, C, shape).astype(np.int32))]
                        kw = dict(num_steps=8, lr=lr, loss=loss, window_size=window)
                        got_m, got_l = refine_cuda(*args, **kw)
                        again_m, again_l = refine_cuda(*args, **kw)
                        want_m, want_l = refine_plain(*args, **kw)
                        torch.cuda.synchronize()
                        err = abs(float(got_l) - float(want_l))
                        max_err = max(max_err, err)
                        case = f"{shape} {loss} C={C} window={window} lr={lr}"
                        check(torch.equal(got_m, want_m), f"refine masks differ from plain: {case}")
                        check(err <= 1e-4 * abs(float(want_l)), f"refine loss off: {case}")
                        check(torch.equal(again_m, got_m) and float(again_l) == float(got_l),
                              f"refine differs between launches: {case}")
                        changed = float((got_m != (args[2] == 1)).float().mean())
                        check(lr < 0.1 or changed > 0.05, f"refine moved no mask: {case}")
                        checks.append({"shape": list(shape), "loss": loss, "C": C,
                                       "window": window, "lr": lr, "changed": changed,
                                       "loss_rel_err": err / abs(float(want_l))})

    # the path's shape, S from DeepLabV3-ResNet50 (random weights, bias centred)
    # at the path's lr; then lr 0.1, where masks move, with random S and with
    # the model's S. Near convergence Adam steps by about lr·sign(g), so at lr
    # 0.1 a pixel whose S is near the threshold ends on the side float noise
    # picks: with the model's S (near 0.5 over wide areas) mismatches are
    # allowed only there
    model = init_weights(DeepLabV3(2, 50, 1.0), torch.Generator().manual_seed(1)).eval().cuda()
    centre_classifier_bias(model, _requests(np.random.default_rng(1), 4, (256, 256)), 256)
    S, x, masks = synthetic_path_batch(model, 4, 256, seed=5)
    rng = np.random.default_rng(9)
    S_rand = rng.uniform(0.1, 1, tuple(S.shape)).astype(np.float32)
    S_rand = torch.from_numpy(S_rand / S_rand.sum(-1, keepdims=True)).cuda()
    path = {}
    for name, S_case, lr in (("model_S_lr_0.01", S, 1e-2), ("random_S_lr_0.1", S_rand, 0.1),
                             ("model_S_lr_0.1", S, 0.1)):
        got_m, got_l = refine_cuda(S_case, x, masks, lr=lr)
        again_m, again_l = refine_cuda(S_case, x, masks, lr=lr)
        want_m, want_l = refine_plain(S_case, x, masks, lr=lr)
        torch.cuda.synchronize()
        agree = float((got_m == want_m).float().mean())
        err = abs(float(got_l) - float(want_l))
        max_err = max(max_err, err)
        near = (S_case[..., 1] - 0.5).abs()
        far_mismatch = int(((got_m != want_m) & (near > 0.05)).sum())
        if name == "model_S_lr_0.1":
            check(agree >= 0.999 and far_mismatch == 0,
                  f"refine masks differ away from the threshold at [4,256,256], {name}: "
                  f"agreement {agree}, {far_mismatch} px with |S-0.5| > 0.05")
        else:
            check(agree >= 0.9999, f"refine mask agreement {agree} < 0.9999 at [4,256,256], {name}")
        check(err <= 1e-4 * abs(float(want_l)), f"refine loss off at [4,256,256], {name}: {err}")
        check(torch.equal(again_m, got_m) and float(again_l) == float(got_l),
              f"refine differs between launches at [4,256,256], {name}")
        changed = float((got_m != masks).float().mean())
        check(lr < 0.05 or changed > 0.01, f"refine moved no mask at [4,256,256], {name}")
        path[name] = {"mask_agreement": agree, "mismatched_px": int((got_m != want_m).sum()),
                      "mismatched_px_far_from_threshold": far_mismatch,
                      "px_with_S_within_0.05_of_threshold": int((near <= 0.05).sum()),
                      "changed_frac": changed, "loss": float(got_l),
                      "loss_rel_err": err / abs(float(want_l))}
    shape = tuple(masks.shape)
    bound_ms, bound_by, ops = refine_bound(shape, 2, 5, 20, "ncut")
    by_steps = {n: cuda_ms(lambda: refine_cuda(S, x, masks, num_steps=n), runs=10)
                for n in (0, 10)}
    timing = {
        "ms": cuda_ms(lambda: refine_cuda(S, x, masks), runs=20),
        "plain_ms": cuda_ms(lambda: refine_plain(S, x, masks), runs=5, warmup=1),
        "bound_ms": bound_ms, "bound_by": bound_by, "gflop": ops / 1e9,
        "ms_at_0_and_10_steps": by_steps,
        "max_abs_err": max(max_err, err), "shape": list(shape), "C": 2, "window": 5,
        "steps": 20, "loss": "ncut",
    }
    emit("refine", checks=len(checks), small_shapes_equal=True,
         small_max_loss_rel_err=max(c["loss_rel_err"] for c in checks),
         small_min_changed_at_lr_0_2=min(c["changed"] for c in checks if c["lr"] > 0.1),
         path_cases=path, fg_frac_before=float(masks.float().mean()), kernels=["refine"],
         **timing)
    return timing


def phase_weakly():
    import copy
    import dataclasses
    import math

    import torch

    from weaklysuperviseddl_tpu_torch.config import (
        AlternatingConfig,
        ClassifierConfig,
        ExperimentConfig,
        SegConfig,
    )
    from weaklysuperviseddl_tpu_torch.ops.cc import label_components_cuda
    from weaklysuperviseddl_tpu_torch.ops.refine import refine_cuda
    from weaklysuperviseddl_tpu_torch.pipelines.weakly import run_weakly_supervised_alternating
    from weaklysuperviseddl_tpu_torch.train.alternating import make_refine_sweep
    from weaklysuperviseddl_tpu_torch.utils.profiling import Stopwatch

    cuts = {"classifier.epochs": 2, "seg.epochs": 1, "alternating.num_alternations": 2,
            "alternating.epochs_per_round": 1, "alternating.refine_repeats": 2}
    base = ExperimentConfig()
    cfg = ExperimentConfig(
        classifier=ClassifierConfig(epochs=2), seg=SegConfig(epochs=1),
        alternating=AlternatingConfig(num_alternations=2, epochs_per_round=1, refine_repeats=2))
    d, r = cfg.data, cfg.alternating.refine
    check((cfg.classifier.depth, cfg.classifier.width_multiplier, cfg.seg.backbone_depth,
           cfg.seg.width_multiplier, d.image_size, d.seg_size, d.num_classes, r.window_size,
           r.num_steps, r.loss, d.synthetic_size) ==
          (50, 1.0, 50, 1.0, 224, 256, 37, 5, 20, "ncut", 128), "weakly config is not full width")
    check(cfg.data == base.data and cfg.mask == base.mask and r == base.alternating.refine,
          "weakly config cut more than depth")

    sw = Stopwatch("cuda")
    torch.cuda.reset_peak_memory_stats()
    # ---- the main path: counts from 0, the pipeline, counts read after ----
    label_components_cuda.launches = 0
    refine_cuda.launches = 0
    t0 = time.perf_counter()
    result = run_weakly_supervised_alternating(cfg, stopwatch=sw, log=lambda *_: None,
                                               device="cuda")
    wall = time.perf_counter() - t0
    launches = {"refine": refine_cuda.launches, "cc_label": label_components_cuda.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    n_train = len(result.mask_store)
    want_refine = math.ceil(n_train / cfg.seg.batch_size) * 2 * 2
    check(launches["refine"] == want_refine,
          f"refine launched {launches['refine']} times on the main path, expected {want_refine}")
    check(launches["cc_label"] > 0, "the main path never launched the cc kernel")
    m = result.metrics
    scalars = {k: m[k] for k in ("iou", "acc", "final_loss", "alt_iou", "alt_acc")}
    check(all(math.isfinite(v) for v in scalars.values()), f"non-finite metrics {scalars}")
    check(len(m["trajectory"]) == 2, "one trajectory entry per alternation")
    images, masks, _ = result.mask_store.as_arrays()
    check(masks.shape == (n_train, 256, 256) and set(np.unique(masks)) <= {0, 1},
          "refined store masks are not binary [N,256,256]")

    # ---- one refinement-sweep batch, the card against the CPU, same weights:
    # at the path's lr (masks cannot move) and at lr 0.1 (they do) ----
    model = result.seg_state.model.eval()
    cpu_model = copy.deepcopy(model).cpu()
    table = torch.arange(4).view(1, 4)
    agree = {}
    for lr in (r.lr, 0.1):
        rl = dataclasses.replace(r, lr=lr)
        dev_masks = torch.from_numpy(masks[:4]).cuda()
        cpu_masks = dev_masks.cpu().clone()
        make_refine_sweep(model, rl, 256)(dev_masks, torch.from_numpy(images[:4]).cuda(),
                                          table.cuda())
        make_refine_sweep(cpu_model, rl, 256)(cpu_masks, torch.from_numpy(images[:4]), table)
        agree[str(lr)] = {"agreement": float((dev_masks.cpu() == cpu_masks).float().mean()),
                          "changed_frac": float((cpu_masks.numpy() != masks[:4]).mean())}
        check(agree[str(lr)]["agreement"] >= 0.995,
              f"card/CPU refinement-sweep agreement {agree[str(lr)]} < 0.995 at lr {lr}")
    step_ms = seg_step_breakdown(result.seg_state, images[:4], masks[:4])

    phases = {name: {"seconds": sw.times[name], "calls": sw.counts[name],
                     "img_per_s": sw.rate(name),
                     **({"first_call_s": sw.first_call_s(name),
                         "marginal_img_per_s": sw.marginal_rate(name)}
                        if sw.marginal_rate(name) is not None else {})}
              for name in sw.times}
    emit("weakly", entry="run_weakly_supervised_alternating",
         models="CamClassifier ResNet-50 (37 classes, 224², layer4 dilated); DeepLabV3-ResNet50 "
                "os8 (2 classes, 256², batch 4); random init (seeds 0 and 1)",
         refine={"size": 256, "C": 2, "window": r.window_size, "steps": r.num_steps,
                 "loss": r.loss},
         cuts=cuts, synthetic_images=d.synthetic_size, train_images=n_train,
         wall_s=wall, phases=phases, metrics=m, peak_mem_gb=peak_gb,
         launches_main_path=launches, card_cpu_sweep_agreement=agree,
         store_fg_frac=float(masks.mean()), seg_step_ms=step_ms)
    return launches


def seg_step_breakdown(state, images, masks) -> dict:
    """Device ms of the parts of one segmentation training step at batch 4
    (after the main path; it trains the model further): gather + preprocess,
    forward + loss, backward, the guarded Adam update (its finite check reads
    one scalar back), and the whole step; and the sweep's forward and kernel
    per batch."""
    import torch

    from weaklysuperviseddl_tpu_torch.losses.basic import per_example_nll
    from weaklysuperviseddl_tpu_torch.ops.refine import refine_cuda
    from weaklysuperviseddl_tpu_torch.train.segmentation import _prep, seg_train_step

    model, opt = state.model, state.optimizer
    raw, m = torch.from_numpy(images).cuda(), torch.from_numpy(masks).cuda()
    x, mm = _prep(raw, m, 256)
    valid = torch.ones(4, dtype=torch.bool, device="cuda")
    model.train()

    def forward():
        logits = model(x.permute(0, 3, 1, 2))
        return per_example_nll(logits, mm.clamp(0, 1), dim=1).mean()

    def backward():
        opt.zero_grad()
        forward().backward()

    out = {"prep_ms": cuda_ms(lambda: _prep(raw, m, 256), runs=10),
           "forward_loss_ms": cuda_ms(forward, runs=5, warmup=1)}
    out["forward_backward_ms"] = cuda_ms(backward, runs=5, warmup=1)
    out["backward_ms"] = out["forward_backward_ms"] - out["forward_loss_ms"]
    out["adam_guard_ms"] = cuda_ms(opt.step, runs=5, warmup=1)
    out["step_ms"] = cuda_ms(lambda: seg_train_step(state, x, mm, valid), runs=5, warmup=1)
    model.eval()
    with torch.no_grad():
        S = torch.softmax(model.logits_nhwc(x), dim=-1).contiguous()
        out["sweep_forward_ms"] = cuda_ms(lambda: torch.softmax(model.logits_nhwc(x), dim=-1),
                                          runs=5, warmup=1)
    out["sweep_refine_ms"] = cuda_ms(lambda: refine_cuda(S, x.contiguous(), mm), runs=10)
    return out


def bilateral_work(B: int, Nq: int, Nk: int, d: int, C: int):
    """(bytes, fp32 operations) of one exact filter call, from its shapes.
    Bytes: the query and key features and the values read once, the output
    written once. Operations per key pair that the function needs: d
    subtractions, d multiplies and d - 1 adds for the squared distance, the
    exp (1), and C multiply-adds (2 each). The -1/2 is not counted per pair:
    it can fold into the O(N) features."""
    ops = B * Nq * Nk * (3 * d + 2 * C)
    nbytes = 4 * B * (Nq * d + Nk * d + Nk * C + Nq * C)
    return nbytes, ops


def roofline(nbytes: float, ops: float):
    """(least ms, what binds it) over the card's HBM and fp32 rates."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def crf_path_inputs(n: int, size: int, stride: int, seed: int):
    """Bilateral features of n synthetic pets at size² (queries: every pixel;
    keys: the stride grid) at the reference's sigmas, and uniform values."""
    import torch

    from weaklysuperviseddl_tpu_torch.data.synthetic import synthetic_pet_arrays
    from weaklysuperviseddl_tpu_torch.masks.densecrf import _bilateral_features

    images, _, _ = synthetic_pet_arrays(n, image_size=size, seed=seed)
    feats = _bilateral_features(torch.from_numpy(images * 255).cuda(),
                                CRF_REFERENCE["bilat_sxy"], CRF_REFERENCE["bilat_srgb"])
    fq = feats.reshape(n, -1, 5).contiguous()
    fk = feats[:, ::stride, ::stride].reshape(n, -1, 5).contiguous()
    rng = np.random.default_rng(seed)
    v = torch.from_numpy(rng.uniform(0, 1, (n, fk.shape[1], 2)).astype(np.float32)).cuda()
    return fq, fk, v


def phase_crf():
    import torch

    from weaklysuperviseddl_tpu_torch.ops.bilateral import (
        gaussian_filter_cuda,
        gaussian_filter_plain_cross,
    )

    small = []
    for B, Nq, Nk, d, C, scale in ((1, 531, 187, 5, 1, 20.0), (1, 531, 187, 5, 2, 20.0),
                                   (1, 531, 187, 5, 3, 20.0), (1, 531, 187, 20, 128, 4.0),
                                   (3, 300, 129, 5, 2, 20.0)):
        rng = np.random.default_rng(len(small))
        fq, fk, v = (torch.from_numpy(a).cuda() for a in (
            rng.uniform(0, scale, (B, Nq, d)).astype(np.float32),
            rng.uniform(0, scale, (B, Nk, d)).astype(np.float32),
            rng.uniform(0, 1, (B, Nk, C)).astype(np.float32)))
        got = gaussian_filter_cuda(fq, fk, v)
        again = gaussian_filter_cuda(fq, fk, v)
        want = torch.stack([gaussian_filter_plain_cross(fq[b], fk[b], v[b]) for b in range(B)])
        torch.cuda.synchronize()
        case = f"[{B},{Nq}]x[{B},{Nk}] d={d} C={C}"
        check(torch.allclose(got, want, rtol=1e-4, atol=1e-5), f"bilateral differs from plain: {case}")
        check(torch.equal(again, got), f"bilateral differs between launches: {case}")
        small.append({"case": case, "max_abs_err": float((got - want).abs().max())})

    # the reference's magnitudes: colours / 5 reach 51, |f|^2 about 7e3
    S = 32
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (S, S, 3)).astype(np.float64)
    yy, xx = np.mgrid[0:S, 0:S] / 50.0
    feats = np.stack([xx, yy] + [img[..., c] / 5.0 for c in range(3)], -1).reshape(1, -1, 5)
    vals = rng.uniform(0, 1, (1, S * S, 2))
    f64 = torch.from_numpy(feats).cuda()
    d2 = ((f64[:, :, None, :] - f64[:, None, :, :]) ** 2).sum(-1)
    gold = torch.exp(-0.5 * d2) @ torch.from_numpy(vals).cuda()
    f32 = f64.float().contiguous()
    got = gaussian_filter_cuda(f32, f32, torch.from_numpy(vals).float().cuda()).double()
    fp64_rel = float((got - gold).abs().max() / gold.abs().max())
    check(fp64_rel < 1e-3, f"bilateral off the float64 sum at reference magnitudes: {fp64_rel}")

    # the path's shape: a pseudo-mask batch of 32 at 224², keys on the stride-2 grid
    fq, fk, v = crf_path_inputs(32, 224, 2, seed=3)
    got = gaussian_filter_cuda(fq, fk, v)
    again = gaussian_filter_cuda(fq, fk, v)
    torch.cuda.synchronize()
    check(torch.equal(again, got), "bilateral differs between launches at the path's shape")
    path_err = 0.0
    for b in (0, 31):
        want = gaussian_filter_plain_cross(fq[b], fk[b], v[b])
        check(torch.allclose(got[b], want, rtol=1e-4, atol=0.0),
              f"bilateral differs from plain at the path's shape, image {b}")
        path_err = max(path_err, float((got[b] - want).abs().max()))
    shape = [32, fq.shape[1], fk.shape[1], 5, 2]
    bound_ms, bound_by = roofline(*bilateral_work(*shape))
    norm_v = torch.ones_like(v[..., :1])
    timing = {
        "ms": cuda_ms(lambda: gaussian_filter_cuda(fq, fk, v), runs=10, warmup=2),
        "ms_C1": cuda_ms(lambda: gaussian_filter_cuda(fq, fk, norm_v), runs=10, warmup=2),
        "plain_ms": cuda_ms(lambda: gaussian_filter_plain_cross(fq, fk, v), runs=2, warmup=1),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_ms_C1": roofline(*bilateral_work(*shape[:4], 1))[0],
        "gflop": bilateral_work(*shape)[1] / 1e9,
        "max_abs_err": path_err, "shape": shape,
    }
    emit("crf", small_cases=small, small_rtol=1e-4, small_atol=1e-5,
         fp64_max_rel_err=fp64_rel, path_max_abs_err=path_err,
         path_output_max=float(got.abs().max()), kernels=["bilateral"], **timing)
    return timing


def full_width_classifier(seed: int):
    import torch

    from weaklysuperviseddl_tpu_torch.models.classifier import CamClassifier
    from weaklysuperviseddl_tpu_torch.models.resnet import init_weights

    model = CamClassifier(37, 50, 1.0)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.cuda().eval()


def phase_cam_fusion():
    import torch

    from weaklysuperviseddl_tpu_torch.cam.layercam import layercam
    from weaklysuperviseddl_tpu_torch.data.preprocess import preprocess_batch
    from weaklysuperviseddl_tpu_torch.data.synthetic import synthetic_pet_arrays
    from weaklysuperviseddl_tpu_torch.ops.cam_fusion import cam_fusion_cuda, cam_fusion_plain

    model = full_width_classifier(0)
    images, labels, _ = synthetic_pet_arrays(32, image_size=224, seed=8)
    x, _ = preprocess_batch(torch.from_numpy((images * 255).astype(np.uint8)).cuda(), None,
                            size=224)
    cls = torch.from_numpy(labels).cuda()
    # the classifier's own activations and gradients, as layercam takes them
    xi = x.permute(0, 3, 1, 2).detach().requires_grad_(True)
    logits, feats = model.features(xi)
    acts = [feats["layer3"], feats["layer4"]]
    grads = torch.autograd.grad(logits.gather(1, cls.long().view(-1, 1)).sum(), acts)
    # as ops/cam_fusion.cam_fusion hands them to the kernel: cuDNN may return
    # the activations in channels-last memory
    acts = [a.detach().contiguous() for a in acts]
    grads = [g.contiguous() for g in grads]

    rng = np.random.default_rng(4)
    ragged = [torch.from_numpy(rng.standard_normal((2, 130, 7, 9)).astype(np.float32)).cuda()
              for _ in range(2)]
    cases, by_shape, max_err = [], {}, 0.0
    for name, (a, g) in (("layer3", (acts[0], grads[0])), ("layer4", (acts[1], grads[1])),
                         ("ragged", ragged)):
        got = cam_fusion_cuda(a, g)
        again = cam_fusion_cuda(a, g)
        want = cam_fusion_plain(a, g)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(err <= 1e-5, f"cam_fusion differs from plain at {name} {tuple(a.shape)}: {err}")
        check(torch.equal(again, got), f"cam_fusion differs between launches at {name}")
        cases.append({"name": name, "shape": list(a.shape), "max_abs_err": err})
        if name != "ragged":
            max_err = max(max_err, err)
            B, C, h, w = a.shape
            # bytes: act and grad read once, the CAM written once; operations:
            # a multiply, a max and an add per element
            bound_ms, bound_by = roofline(4 * B * h * w * (2 * C + 1), 3 * B * C * h * w)
            by_shape[name] = {
                "shape": list(a.shape),
                "ms": cuda_ms(lambda: cam_fusion_cuda(a, g), runs=50, warmup=5),
                "plain_ms": cuda_ms(lambda: cam_fusion_plain(a, g), runs=50, warmup=5),
                "bound_ms": bound_ms, "bound_by": bound_by}

    # ---- the main path: the kernel's count from 0, layercam(fusion="pallas"), read after ----
    cam_fusion_cuda.launches = 0
    cam_k, _ = layercam(model, x, cls, output_size=224, fusion="pallas")
    torch.cuda.synchronize()
    launches = cam_fusion_cuda.launches
    cam_p, _ = layercam(model, x, cls, output_size=224, fusion="xla")
    layercam_err = float((cam_k - cam_p).abs().max())
    check(launches == 2, f"layercam(fusion='pallas') launched cam_fusion {launches} times, not 2")
    check(layercam_err <= 1e-5, f"layercam pallas vs xla: {layercam_err}")
    check(tuple(cam_k.shape) == (32, 224, 224) and bool(torch.isfinite(cam_k).all()),
          "layercam CAMs are not finite [32,224,224]")
    layer4 = by_shape["layer4"]
    emit("cam_fusion", cases=cases, by_shape=by_shape, layercam_max_abs_err=layercam_err,
         layercam_ms={f: cuda_ms(lambda: layercam(model, x, cls, output_size=224, fusion=f),
                                 runs=3, warmup=1) for f in ("pallas", "xla")},
         launches_main_path=launches, kernels=["cam_fusion"])
    return {"launches": launches, "max_abs_err": max_err, "by_shape": by_shape,
            "ms": layer4["ms"], "plain_ms": layer4["plain_ms"], "bound_ms": layer4["bound_ms"],
            "bound_by": layer4["bound_by"], "shape": layer4["shape"]}


def phase_weakly_crf():
    import dataclasses
    import math
    from unittest import mock

    import torch

    from weaklysuperviseddl_tpu_torch.config import (
        AlternatingConfig,
        ClassifierConfig,
        ExperimentConfig,
        MaskConfig,
        SegConfig,
    )
    from weaklysuperviseddl_tpu_torch.data.dataset import load_split_data
    from weaklysuperviseddl_tpu_torch.data.loader import batches
    from weaklysuperviseddl_tpu_torch.masks import densecrf
    from weaklysuperviseddl_tpu_torch.masks.pseudo import (
        ResidentCams,
        _derive_batch,
        extract_cams,
        masks_from_cams,
    )
    from weaklysuperviseddl_tpu_torch.ops.bilateral import (
        gaussian_filter_cuda,
        gaussian_filter_plain_cross,
    )
    from weaklysuperviseddl_tpu_torch.ops.cam_fusion import cam_fusion_cuda
    from weaklysuperviseddl_tpu_torch.ops.cc import label_components_cuda
    from weaklysuperviseddl_tpu_torch.ops.refine import refine_cuda
    from weaklysuperviseddl_tpu_torch.pipelines.weakly import (
        crf_kwargs,
        run_weakly_supervised_alternating,
    )
    from weaklysuperviseddl_tpu_torch.utils.profiling import Stopwatch

    cuts = {"classifier.epochs": 2, "seg.epochs": 1, "alternating.num_alternations": 1,
            "alternating.epochs_per_round": 1, "alternating.refine_repeats": 2}
    base = ExperimentConfig()
    cfg = ExperimentConfig(
        classifier=ClassifierConfig(epochs=2), mask=MaskConfig(use_crf=True),
        seg=SegConfig(epochs=1, loss_fn="lovasz_softmax"),
        alternating=AlternatingConfig(num_alternations=1, epochs_per_round=1, refine_repeats=2))
    d, m = cfg.data, cfg.mask
    check(dataclasses.replace(m, use_crf=False) == base.mask and cfg.data == base.data
          and cfg.cam == base.cam, "weakly_crf config cut more than depth")
    check(crf_kwargs(cfg) == CRF_REFERENCE, f"CRF kwargs {crf_kwargs(cfg)} are not the reference's")

    sw = Stopwatch("cuda")
    torch.cuda.reset_peak_memory_stats()
    # ---- the main path: every count from 0, the pipeline, counts read after ----
    for kernel in (gaussian_filter_cuda, cam_fusion_cuda, label_components_cuda, refine_cuda):
        kernel.launches = 0
    t0 = time.perf_counter()
    result = run_weakly_supervised_alternating(cfg, stopwatch=sw, log=lambda *_: None,
                                               device="cuda")
    wall = time.perf_counter() - t0
    launches = {"bilateral": gaussian_filter_cuda.launches, "cam_fusion": cam_fusion_cuda.launches,
                "cc_label": label_components_cuda.launches, "refine": refine_cuda.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    n_train = len(result.mask_store)
    want_k3 = math.ceil(n_train / d.batch_size) * (1 + m.crf_iters)
    check(launches["bilateral"] == want_k3,
          f"bilateral launched {launches['bilateral']} times on the path, expected {want_k3}")
    check(launches["cc_label"] > 0 and launches["refine"] > 0,
          f"the CRF path did not launch cc_label and refine: {launches}")
    check(launches["cam_fusion"] == 0, "fusion='auto' launched the cam_fusion kernel")
    metrics = result.metrics
    scalars = {k: metrics[k] for k in ("iou", "acc", "final_loss", "alt_iou", "alt_acc")}
    check(all(math.isfinite(v) for v in scalars.values()), f"non-finite metrics {scalars}")

    # ---- 32 train images, CAMs from the run's classifier ----
    train_ds, _ = load_split_data(d.root, train_ratio=d.train_ratio, seed=d.seed,
                                  synthetic_size=d.synthetic_size, image_size=d.image_size,
                                  num_classes=d.num_classes)
    resident = extract_cams(batches(train_ds, d.batch_size, pad_to_full=True), result.classifier,
                            image_size=d.image_size, max_images=32)
    kw = crf_kwargs(cfg)

    def crf_masks(res, **over):
        store = masks_from_cams(res, cam_thresh=m.cam_thresh, use_crf=True,
                                crf_kwargs={**kw, **over})
        return store.as_arrays()[1]

    kernel_masks = crf_masks(resident)
    with mock.patch.object(densecrf, "gaussian_filter_cross", gaussian_filter_plain_cross):
        plain_masks = crf_masks(resident)
    plain_agree = float((kernel_masks == plain_masks).mean())
    check(plain_agree >= 0.999, f"CRF masks, kernel vs plain filter on the card: {plain_agree}")
    cpu2 = ResidentCams(resident.images_raw[:2].cpu(), resident.cams[:2].cpu(),
                        resident.store_images[:2].cpu(), resident.image_size, 2)
    t_cpu = time.perf_counter()
    cpu_masks = crf_masks(cpu2)
    cpu_s = time.perf_counter() - t_cpu
    cpu_agree = float((kernel_masks[:2] == cpu_masks).mean())
    check(cpu_agree >= 0.999, f"CRF masks, card vs CPU on 2 images: {cpu_agree}")
    exact_masks = crf_masks(resident, bilat_backend="attention")
    per_image = (kernel_masks == exact_masks).reshape(32, -1).mean(axis=1)
    check(per_image.mean() >= 0.99,
          f"subsampled vs attention CRF: mean agreement {per_image.mean()} < 0.99")
    fg = float(kernel_masks.mean())
    check(0.01 < fg < 0.99, f"CRF masks are empty or full: foreground {fg}")

    # one pseudo-mask batch of 32 through the CRF, by stage
    x = resident.images_raw[:32]
    cam = resident.cams[:32]
    batch_ms = {
        "crf_and_keep_largest": cuda_ms(lambda: _derive_batch(
            x, cam, m.cam_thresh, True, True, d.image_size, kw), runs=3, warmup=1),
        "attention_crf_and_keep_largest": cuda_ms(lambda: _derive_batch(
            x, cam, m.cam_thresh, True, True, d.image_size, {**kw, "bilat_backend": "attention"}),
            runs=2, warmup=1),
        "threshold_and_keep_largest": cuda_ms(lambda: _derive_batch(
            x, cam, m.cam_thresh, True, False, d.image_size, kw), runs=5, warmup=1),
    }
    phases = {name: {"seconds": sw.times[name], "calls": sw.counts[name],
                     "img_per_s": sw.rate(name)} for name in sw.times}
    emit("weakly_crf", entry="run_weakly_supervised_alternating",
         crf=kw, seg_loss=cfg.seg.loss_fn, cuts=cuts, train_images=n_train, wall_s=wall,
         phases=phases, metrics=metrics, peak_mem_gb=peak_gb, launches_main_path=launches,
         expected_bilateral_launches=want_k3,
         masks_kernel_vs_plain_agreement=plain_agree, masks_card_vs_cpu_agreement=cpu_agree,
         cpu_crf_2_images_s=cpu_s,
         subsampled_vs_attention={"mean": float(per_image.mean()),
                                  "min": float(per_image.min())},
         crf_fg_frac=fg, batch32_ms=batch_ms)
    return launches


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
    refine_timing = phase_refine()
    weakly_launches = phase_weakly()
    crf_timing = phase_crf()
    fusion = phase_cam_fusion()
    crf_launches = phase_weakly_crf()

    from weaklysuperviseddl_tpu_torch.masks.components import label_components
    from weaklysuperviseddl_tpu_torch.ops.cc import label_components_cuda

    def by_path(name, serve=0, weakly=0, cam_fusion=0):
        paths = {"serve": serve, "weakly": weakly, "cam_fusion": cam_fusion,
                 "weakly_crf": crf_launches[name]}
        return {"launches": sum(paths.values()), "launches_by_path": paths}

    # cc: on the masks the serving path gave it, the served argmax [64,256,256]
    shape = tuple(served_masks.shape)
    kernel_line = {"kernels": [{
        "name": "cc_label",
        "route": "cuda",
        "source": "weaklysuperviseddl_tpu_torch/csrc/cc.cu",
        "replaces": "weaklysuperviseddl_tpu/ops/pallas_cc.py:29",
        **by_path("cc_label", serve=launches, weakly=weakly_launches["cc_label"]),
        "max_abs_err": max_err,
        "ms": cuda_ms(lambda: label_components_cuda(served_masks)),
        "plain_ms": cuda_ms(lambda: label_components(served_masks), runs=20, warmup=1),
        "bound_ms": cc_bound_ms(shape),
        "bound_by": "bytes",
        "library_ms": None,  # no single PyTorch call labels connected components
        "shape": list(shape),
    }, {
        "name": "refine",
        "route": "cuda",
        "source": "weaklysuperviseddl_tpu_torch/csrc/refine.cu",
        "replaces": "weaklysuperviseddl_tpu/ops/pallas_refine.py:45",
        **by_path("refine", weakly=weakly_launches["refine"]),
        "max_abs_err": refine_timing["max_abs_err"],  # of the loss; masks equal or >= 0.9999
        "ms": refine_timing["ms"],
        "plain_ms": refine_timing["plain_ms"],
        "bound_ms": refine_timing["bound_ms"],
        "bound_by": refine_timing["bound_by"],
        "library_ms": None,  # no single PyTorch call computes the refinement
        "shape": refine_timing["shape"],
    }, {
        "name": "bilateral",
        "route": "cuda",
        "source": "weaklysuperviseddl_tpu_torch/csrc/bilateral.cu",
        "replaces": "weaklysuperviseddl_tpu/ops/pallas_bilateral.py:147",
        **by_path("bilateral"),
        "max_abs_err": crf_timing["max_abs_err"],  # at the path's shape, against plain
        "ms": crf_timing["ms"],
        "plain_ms": crf_timing["plain_ms"],
        "bound_ms": crf_timing["bound_ms"],
        "bound_by": crf_timing["bound_by"],
        "library_ms": None,  # no single PyTorch call computes the Gaussian-kernel filter
        "shape": crf_timing["shape"],  # [B, Nq, Nk, d, C]
    }, {
        "name": "cam_fusion",
        "route": "cuda",
        "source": "weaklysuperviseddl_tpu_torch/csrc/cam_fusion.cu",
        "replaces": "weaklysuperviseddl_tpu/ops/pallas_cam.py:28",
        **by_path("cam_fusion", cam_fusion=fusion["launches"]),
        "max_abs_err": fusion["max_abs_err"],
        "ms": fusion["ms"],
        "plain_ms": fusion["plain_ms"],
        "bound_ms": fusion["bound_ms"],
        "bound_by": fusion["bound_by"],
        "library_ms": None,  # no single PyTorch call computes the fusion
        "shape": fusion["shape"],  # layer4; layer3 in the cam_fusion line
    }]}
    print(smi, flush=True)
    print(json.dumps(kernel_line), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
