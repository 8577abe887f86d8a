#!/usr/bin/env python3
"""Drives the PyTorch port (weaklysuperviseddl_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each:
  1. device  - nvidia-smi name and power limit, torch's device name, TF32 flags
               (both set off: the serving path runs float32).
  2. build   - every CUDA source of the port, compiled with nvcc in parallel.
  3. cc      - the connected-components kernel against its plain PyTorch
               version on the card, on every mask family, at [64,256,256],
               [32,224,224], [3,250,333] (the one-block image plan) and
               [2,512,512] (the tiles plan): labels and keep-largest masks
               exactly equal, two launches identical, the plan the shape
               chooses launched. Every family timed at [64,256,256] and
               [32,224,224] (CUDA events, back to back, device ms by kernel).
  4. serve   - DeepLabV3-ResNet50 at full width (2 classes, seeded random
               weights) through Predictor(size=256, max_batch=64, clean=True,
               packed=True): masks against the same weights on the CPU, a
               MaskServer answering MaskClient requests from 4 threads (each
               reply equal to a direct Predictor call on the batch it was
               served in), predict_many throughput, request latency, and a
               stage breakdown of one batch of 64. The kernel's launch count is
               reset just before this main path is driven and read just after.
  4a. goldens - the host goldens (native/wsdl_native.cpp, the port's copy of
               the JAX package's C++, built with g++ in the phase; a failed
               build fails it): K2's labels and keep-largest on the served
               [64,256,256] argmax and on every mask family at [64,256,256]
               against the union-find image by image (equal); the attention
               CRF (K3) on 2 pets at 64² against the O(N²) exact CRF (mean
               error < 1e-4, argmax equal off near-ties); the lattice CRF on
               4 pets at 224² against the golden lattice CRF (argmax >=
               0.99); the reference's CRF parameters; the goldens' host ms.
  5. serve_int8 - the same model quantized by the port's int8 PTQ
               (Predictor.quantize on 64 synthetic pets, as the CLI without
               --calib-dir): 77 sites (58 conv, 19 ASPP taps); one forward at
               batch 64 with every site's Q1 gather and Q2 epilogue held
               bit-equal to their plain versions and the int32 GEMM to a float64
               product, each timed at its shape beside its bound; device ms of
               the int8 forward by kind of kernel; the path (predict_many over
               128 pets and 4 MaskServer requests, /healthz int8) with the
               counts reset just before and read just after; the card's int8
               masks against the CPU port's under the same calibration file
               on rows 0, 1, 62 and 63 of the first batch-64 launch (>= 0.995);
               int8 against float32 masks; predict_many img/s and the model's
               ms an image, float32 and int8, at every bucket: img/s over a
               window of at least 256 images and about 1 s, 3 times, each as
               its median, least and largest reading.
  6. refine  - the refinement kernel against its plain PyTorch version on the
               card: at [2,16,16], [1,20,24] and [2,37,53], both losses, C=2 and
               3, windows 5 and 3, lr 1e-2 and 0.2 (where masks move), plan v1
               and every other plan (v1sym at C=2, v2, v2_aff), masks exactly
               equal and loss rtol 1e-4, v2 and v2_aff also equal to v1 (loss
               rtol 1e-5); at the path's shape [4,256,256], C=2, 20 steps, with S
               from a DeepLabV3-ResNet50 forward on synthetic pets, v1, v1sym and
               v2_aff: mask agreement >= 0.9999 and loss rtol 1e-4 at lr 1e-2
               and, with random S, at lr 0.1 (masks move); with the model's S at
               lr 0.1, mismatches only where S is within 0.05 of the threshold;
               v2_aff equal to v1; two launches bit-identical; the pixels the
               window pass's edge phase took, as the kernel counts them per
               tile, equal to the pixels within window//2 of an edge (their
               share, and that of the tiles that skipped the phase, are
               reported). The time of v1,
               v1sym and v2_aff (v2 runs v1's kernel) at [4,256,256] ncut 20
               steps, [8,256,256] 10 steps and [4,256,256] boundary 75 steps,
               beside the bound.
  7. window  - the window-loss kernels (sum and gradient, through the autograd
               Function) against the plain losses on the card: the fuzz shapes
               [2,11,13,2] w3, [2,16,24,3] w5, [2,9,32,2] w7 and the full width
               [8,256,256,2] w5 on synthetic pets, both losses, values rtol 1e-5,
               gradients rtol 1e-4 / atol 1e-7, two launches bit-identical;
               forward, backward and plain times beside the bounds, and each
               wrapper's host time per call. Then the
               path, where masks move: one image's refinement under autograd
               through fused_local_normalized_cut_loss (20 Adam steps at lr 0.1)
               and through fused_boundary_loss (the boundary protocol's 75 steps
               at lr 1e-2), the kernels' counts reset just before and read just
               after (95 each); each step's W against the plain loss (rtol
               1e-5), masks against refine_plain's as in the refine phase, loss
               rtol 1e-4; timed beside K1.
  8. weakly  - the training main path through run_weakly_supervised_alternating
               at full width: ResNet-50 CAM classifier (37 classes, 224², layer4
               dilated) → LayerCAM → pseudo-masks → DeepLabV3-ResNet50 os8
               (256², batch 4) ↔ refinement (256², C=2, window 5, 20 steps,
               ncut; plan "auto" = v1sym). Cut in depth only (listed in the
               line). With a checkpoint_dir: a snapshot per alternation (the last
               one held bit-equal to the run's final state; its size and seconds
               reported). Both kernels' launch counts are reset just before and
               read just after; then one refinement-sweep batch on the card
               against the same weights on the CPU, at the path's lr and at lr
               0.1 (mask agreement >= 0.995), and a device-time breakdown of one
               training step.
  9. crf     - the bilateral-filter kernel against its plain PyTorch version on
               the card: ragged 531x187 with d 5 and C 1, 2, 3; d 20 with C 128;
               a batch of 3 with different features per image (rtol 1e-4, atol
               1e-5); the reference's magnitudes against a float64 sum (max
               error < 1e-3 of the largest output); the path's shape
               [32,50176]x[32,12544], d 5, C 2, against the plain version on 2
               of the 32 images (rtol 1e-4) and two launches bit-identical;
               the float64 check within 1e-4.
               Times with CUDA events beside the bound, and the host's part of
               a call and events around calls traced by the profiler (where the
               profiler's kernel time and the events' disagree).
 10. cam_fusion - the LayerCAM-fusion kernel against its plain version at the
               full-width classifier's layer3 and layer4 shapes (its own
               activations and gradients on synthetic pets) and at a ragged
               [2,130,7,9] (atol 1e-5); then the path: layercam(fusion="pallas")
               against fusion="xla" at 224², batch 32 (atol 1e-5), the kernel's
               count reset just before and read just after. Each shape's
               cluster size (CTAs an image) and the clusters the card holds at
               once; times and host time beside the bound.
 11. weakly_crf - the CRF pseudo-mask path through
               run_weakly_supervised_alternating at full width: as weakly, with
               mask.use_crf (the reference's parameters: subsampled, stride 2, 5
               iterations, sigma 1/50/5, compat 2/10) and seg.loss_fn
               lovasz_softmax; every kernel's count reset just before and read
               just after (the bilateral kernel must launch ceil(n/32)*6 times,
               K1 all v1sym);
               then on 32 train images with the run's classifier: CRF masks from
               the kernel against the plain filter on the card (>= 0.999), the
               card against the CPU on 1 image (>= 0.999), and subsampled
               against attention per image (mean >= 0.99).
 12. weakly_boundary - the reference's boundary-loss protocol
               (AlternatingDirectionBoundaryLoss.py:153-206) through
               run_weakly_supervised_alternating at full width, set by the CLI's
               dotted overrides (refine.loss boundary, num_steps 75, lambda 0.5,
               sigma_space 10, one sweep per round, CAM threshold 0.5); models,
               data and depth cuts as weakly with one alternation; the counts
               reset just before and read just after (K1 once per batch of 4,
               all v1sym; K2); the fraction of mask pixels the sweep changed
               (the uploaded masks against the store's after the run); then one
               refinement batch of 1 image on the card against the CPU with the
               same weights (>= 0.995).
 13. weakly_resume - a copy of the weakly run's alt_000 (what a run stopped
               after one alternation leaves) resumed through
               run_weakly_supervised_alternating(resume=True) at weakly's config:
               the restored state bit-equal to alt_000's files (model state
               dict, Adam moments and counters, step, the store), K1 once per
               sweep batch of the continuation, all v1sym (counts reset just
               before, read just after), the final masks >= 0.995 equal to the
               uninterrupted run's (bit equality reported: the weakly phase ran
               without cudnn.deterministic); snapshot MB and checkpoint
               seconds. Then a deterministic pair under cudnn.deterministic,
               cut to 32 pets, 1 classifier epoch and 1 sweep a round: an
               uninterrupted run at two alternations and a resume from a copy
               of its alt_000, bit-equal in final masks, segmentation state
               (parameters, BatchNorm statistics, Adam's moments and
               counters, step) and alt_iou.
 14. serve_checkpoint - Predictor(clean=True, packed=True) over the weakly
               run's last snapshot, loaded by the CLI's loader, and over its
               in-memory final model: masks equal on one batch of 64 at 256²; K2
               counted; a ResNet-50 state refused by the smoke ResNet-18; then
               the snapshot quantized to int8 (64 synthetic pets) and its
               int8-vs-float32 agreement; Q1, Q2 and the GEMM counted.
 15. supervised - run_supervised_training at full width (DeepLabV3-ResNet50,
               256², batch 4, 128 synthetic pets), cut to 1 epoch and 1 test run:
               metrics finite and in [0, 1]; evaluate_multiclass_dataset of the
               trained model on the card against the CPU over 16 test images
               (within 0.005 on acc and IoU); training img/s.
 16. ablations - run_ablation_experiment at full width with an untrained
               classifier (as the CLI's), the grid's first point x 2 repeats,
               seg.epochs 1: K2's count reset just before and read just after
               (one launch per batch of 32 per run, image plan); the grid's
               keep-largest masks equal to the plain keep-largest of the same
               thresholded CAMs in the run's order; seconds per grid run.
 17. basnet  - BASNet(3,1) at 256² (random weights, seed 0; no hand kernel):
               its dout for 8 synthetic test pets on the card against the CPU
               (<= 1e-4, thresholded maps >= 0.999 equal); the reference's
               protocol through run_inference on 10 pets and through the CLI's
               `basnet` on the card by default (mean IoU equal); saliency_step
               img/s at batch 16 (20 calls with upload and readback); the
               model's ms an image at batch 1, 8, 16 and 32 (three medians of
               CUDA events) and the device ms of a batch-16 forward by kind of
               kernel; a cut of the demo's training recipe (64 pets x 30 epochs,
               batch 8): img/s, ms a step, peak memory, the loss falling and the
               held-out IoU above random init's.
 18. bf16    - the 16-bit compute dtypes, bfloat16 and float16 each: K5 on
               the 16-bit classifier's own layer3 and layer4 activations and
               gradients (32 pets, 224²): bit-equal to K5 on their float32
               upcasts, within 1e-6 of plain, two launches identical, timed
               beside its bound (bytes of 16-bit inputs) and beside the
               float32 launch; the path, layercam(fusion="pallas") on that
               classifier, with the counts by input type reset just before
               and read just after (2 launches of the type); the weakly
               phase's cut cycle with classifier.dtype = seg.dtype = the type
               (K1 and K2 counted), its final masks against the float32
               weakly run's (agreement reported), its trained models against
               float32 builds of the same weights (pseudo-masks of 32 pets
               and DeepLabV3's argmax on 8, each >= 0.99); the float16 step
               at batch 4 eager and graphed (chunks of 8: events, device and
               host ms, capture s, peak GB); a segmentation step at batch 4 and BASNet (a
               forward at batch 16, a train step at batch 8) in float32, TF32
               (flags on for that measurement only) and bfloat16: ms, img/s,
               peak GB; BASNet's bfloat16 saliency masks against float32's
               (>= 0.99).
 19. crf_backends - the pseudo-mask stage's CRF through masks_from_cams(
               use_crf=True) at each of the five bilateral backends, with
               pipelines/weakly.crf_kwargs's reference parameters: 32
               synthetic pets at 224², CAMs from the full-width classifier;
               the counts reset just before the extraction and the five
               derivations and read just after (K3 6 launches each for
               attention and subsampled, K2 once a backend, image plan). Per
               backend: ms a batch of 32 (CUDA events, median of 3), peak GB,
               mask agreement with attention's (reported), marginals
               bit-equal across two launches (the lattice's checked); card
               against CPU masks on images 0 and 31 for grid and lattice
               (>= 0.999) and RFF (>= 0.99, the same seeded draws); the
               lattice's precompute and one filter call at batch 32 (ms),
               its vertices against its M entries and its raw filter
               against K3's exact one on image 0.
 20. pseudo_stage - 1024 synthetic pets at 224², batch 32: extract_cams
               resident and with spill_to_host (windows of 8 batches), and
               masks_from_cams of each, K2's count reset just before and read
               just after (one launch a batch); img/s and peak GB per mode;
               spilled against resident CAMs and masks (cuDNN's default
               backward differs between any two runs of a batch in the last
               bits, so: masks >= 0.9999 by default, CAMs and masks bit-equal
               with cudnn.deterministic); a MaskStore directory takes all 1024
               pairs (the writer, "native" or "pil" with its build error;
               seconds to submit and to flush; MaskStore.load equal to the
               arrays); download_data(limit=256) from a Pet-layout directory
               the phase writes, through batches with and without prefetch
               into LayerCAM: img/s from disk.
 21. compat  - the reference-named surface (weaklysuperviseddl_tpu_torch/compat/)
               at full width, the reference's flow: FrozenResNetCAM (ResNet-50
               dilated, 37 classes, 224²), train_fc_only (1 epoch, 32
               synthetic pets), LayerCAMGenerator(["layer3", "layer4"]),
               generate_pseudo_masks over 64 pets into a directory of the
               checkout (K2), apply_dense_crf on one 224² image with the
               reference's CRF and keep_largest on its mask (K3, K2),
               CAMGenerator.generate_bg_cam, SegmentationModel's
               train_segmentation_model (DeepLabV3-R50 at 256², 1 epoch on
               those 64 PNG pairs), refine_pseudo_mask at the path's lr and at
               0.2 (K1); K1, K2 and K3 counted from 0 over the flow (3 K2, 6
               K3, 2 K1 v1sym; K5 off the path: fusion "auto", as in JAX) and
               each step's seconds. Then each compat output against the core
               call it wraps on the same tensors (bit-equal; LayerCAM within
               1e-5) and the card against the CPU: the pseudo-masks of 4 pets,
               the CRF mask (>= 0.999) and the refined mask at lr 0.2 (>=
               0.995).
 22. mesh    - the ('data', 'model') mesh under NCCL with a world of every
               visible card (in this process on one card; else one spawned
               rank a card). The path, every count reset just before and
               read just after: the port's dryrun (JAX's dryrun_multichip
               stage for stage, its lines printed), the alternating loop
               on the mesh (full-width DeepLabV3-R50, 8 pets at 256², one
               sweep: K1 2 launches, all v1sym), Predictor(mesh=) on a
               local mesh of the cards at full width, float32 and int8,
               clean and packed (K2, Q1, Q2; the dryrun's CRFs K3 6
               times). Then: those masks bit-equal to the one-device
               Predictor's; the sharded step at batch 4 a shard against
               the one-device step from the same seed (at a world of 1 the
               forward's bits equal; the parameters within 2.5e-4, as two
               one-device steps, whose backward adds with atomics); and
               refine_spatial_sharded at 1024², 3 steps, against
               refine_plain (loss rtol 1e-4, masks > 0.999). Stage seconds.
 23. foundation - the foundation baseline at full width, no kernel on its
               path: hf_detector(config=grounding_dino_base()) (Swin-B
               384, BERT-base over a 30522-entry vocab with the special
               tokens at bert-base-uncased's ids, 900 queries, 6 + 6
               layers) and hf_segmenter(config=sam_vit_base()) (ViT-B,
               1024²), weights drawn from torch.Generators seeded 0 and 1,
               through FoundationPipeline and evaluate_pipeline_on_dataset
               on 16 synthetic test pets at 224² at the reference's
               thresholds (0.3, 0.25), every kernel count reset just before
               and read just after (all 0): img/s, boxes an image, peak GB,
               the mask PNGs written. Device ms stage by stage on one image
               (CUDA events): the detector's preprocess, Swin, BERT,
               encoder, decoder, post-process; the segmenter's preprocess,
               image encoder, prompt and mask decoder at 1 box and at the
               detector's count. The card against the CPU on that image
               (the same seeds): the top-900 proposals equal but where
               their best logits lie within 1e-5 of the cut, the boxes both
               keep within 1e-2 px, SAM's logits on the CPU pipeline's
               boxes within 1e-3 of the largest, >= 0.999 of the pipeline's
               mask pixels equal.
The serve_int8 line also profiles DeepLabV3's float32 forward layer by
layer at batches 16 and 32 (each convolution of layer3, layer4 and the head
replayed alone: its kernels and device ms an image; those whose kernels
change), and times the whole forward at 16, 32 and 64 as it runs, with
cudnn.benchmark and in channels_last.
Then the script's seconds by phase, the card's name and power limit, the
kernels line (each kernel's ``ms`` is the CUDA-event time of one call,
``back_to_back_ms`` the same over calls in a row, ``device_ms`` the summed
kernel time per call from a torch.profiler trace, ``host_ms`` the wrapper's
host time per call over calls in a row; the crf and refine phase
lines add ``bound_share``, bound_ms / ms; Q1's and Q2's rows sum their calls
over one int8 forward at batch 64, and Q1's carries the int32 GEMM's sums
against its bound at 1979 TOPS), and the last line
``{"ok": true, "device": {...}}``. Any failed check raises: no result is
printed. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import pathlib
import shutil
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
FP32_OPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores, NVIDIA data sheet
INT8_OPS_PER_S = 1979e12   # H100 SXM dense int8 tensor cores, NVIDIA data sheet
# the reference's CRF parameters (AlternatingDirectionCutLoss.py:183-204) and
# the config's default backend
# the snapshots of the weakly and weakly_resume phases (about 0.5 GB each) and
# serve_int8's calibration file, inside the checkout (gitignored) and removed
# when the script ends
CKPT_ROOT = pathlib.Path(__file__).resolve().parent / "chip_smoke_ckpt"
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


def device_ms(fn, runs: int = 10, warmup: int = 2, traces: int = 3):
    """Device time per call of what ``fn`` runs on the card, from a
    torch.profiler CUDA trace: (summed kernel ms, {kernel name: ms}), or
    (None, {}) if none of ``traces`` traces in a row holds device time (a
    trace of a few short kernels now and then comes back empty on the card).
    Unlike cuda_ms it leaves out the gaps between a call's launches and the
    host's time before the first."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    by_name = {}
    for _ in range(traces):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0)
            if us > 0:
                by_name[e.key] = us / runs / 1e3
        if by_name:
            break
    return (sum(by_name.values()) if by_name else None), by_name


def kernel_ms(fn, runs: int = 10, warmup: int = 2) -> dict:
    """{"ms": CUDA-event time of one call (cuda_ms), "back_to_back_ms": CUDA
    events around ``runs`` calls in a row, per call (no idle card between
    calls), "device_ms": the summed kernel time per call from a profiler
    trace (None if the trace has none)}."""
    import torch

    ms = cuda_ms(fn, runs=runs, warmup=warmup)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    end.synchronize()
    return {"ms": ms, "back_to_back_ms": start.elapsed_time(end) / runs,
            "device_ms": device_ms(fn, runs, warmup)[0]}


def host_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    """Host time of one call of ``fn``: the wall clock around ``runs`` calls
    in a row that nothing waits for, per call (the card runs behind; keep
    runs x launches a call under the launch queue's depth of about 1000)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / runs * 1e3


def events_under_profiler_ms(fn, runs: int = 10, warmup: int = 2) -> float:
    """CUDA events around ``runs`` calls in a row while torch.profiler traces
    them, per call: set beside back_to_back_ms and device_ms, it tells a
    kernel that runs faster under the trace from a trace that leaves time out."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(runs):
            fn()
        end.record()
        end.synchronize()
    return start.elapsed_time(end) / runs


def short_name(kernel: str) -> str:
    """A kernel's name from the profiler without its return type, namespace
    and arguments (template arguments kept)."""
    name = kernel.replace("(anonymous namespace)::", "").split("(")[0]
    depth, start = 0, 0
    for i, ch in enumerate(name):  # the last "::" outside template brackets
        depth += (ch == "<") - (ch == ">")
        if depth == 0 and name.startswith("::", i):
            start = i + 2
    return name[start:].removeprefix("void ").strip()


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


def ptxas_summary(log: str) -> dict:
    """{kernel: "S bytes stack frame, ...; Used N registers, ..."} from nvcc's
    -Xptxas -v report, the kernels' names demangled by c++filt where the
    host has it (else left mangled)."""
    out, entry = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
            out[entry] = ""
        elif entry and ("stack frame" in ln or "registers" in ln):
            part = ln.split(":", 1)[-1].strip()
            out[entry] = f"{out[entry]}; {part}" if out[entry] else part
    try:
        names = subprocess.run(["c++filt"], input="\n".join(out), capture_output=True, text=True,
                               timeout=60).stdout.splitlines()
    except OSError:
        return out
    if len(names) != len(out):
        return out
    return {short_name(n): v for n, v in zip(names, out.values())}


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from weaklysuperviseddl_tpu_torch.ops import build

    sources = sorted(p.name for p in build.CSRC_DIR.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, all at once
        libs = list(pool.map(build.build, sources))
    seconds = time.perf_counter() - t0
    ptxas = {lib.name: ptxas_summary(lib.with_suffix(".log").read_text()) for lib in libs}
    emit("build", sources=sources, seconds=round(seconds, 3), ptxas=ptxas)


def golden_crf_inputs(n: int, size: int, seed: int):
    """n synthetic pets at size² as uint8 RGB, and a noisy CAM of each pet's
    foreground (0.7 inside, 0.3 outside, ±0.25 uniform noise, clipped to
    [0.02, 0.98]) as the CRF's probs [n,size,size,2] and the golden's unary
    -log(probs)."""
    from weaklysuperviseddl_tpu_torch.data.synthetic import synthetic_pet_arrays

    images, _, trimaps = synthetic_pet_arrays(n, image_size=size, seed=seed)
    rgb = np.round(images * 255).astype(np.uint8)
    noise = np.random.default_rng(seed).uniform(-0.25, 0.25, trimaps.shape)
    cam = np.clip(np.where(trimaps == 1, 0.7, 0.3) + noise, 0.02, 0.98).astype(np.float32)
    probs = np.stack([1 - cam, cam], axis=-1)
    return rgb, probs, -np.log(probs)


def phase_goldens(served_masks):
    """The card's kernels against the host goldens (native/wsdl_native.cpp,
    the port's copy of the JAX package's C++, built with g++ here): K2's
    labels and keep-largest on the served masks and every mask family
    against the union-find image by image (equal); K3 through the attention
    CRF against the O(N²) exact CRF at 64² (float-level); the lattice CRF at
    the path's 224² against the golden lattice CRF (argmax >= 0.99). The
    golden's host ms beside each. A golden that does not build fails here."""
    import torch

    from weaklysuperviseddl_tpu_torch import native
    from weaklysuperviseddl_tpu_torch.masks import synthetic
    from weaklysuperviseddl_tpu_torch.masks.components import keep_largest_batch
    from weaklysuperviseddl_tpu_torch.masks.densecrf import densecrf_inference
    from weaklysuperviseddl_tpu_torch.ops.bilateral import gaussian_filter_cuda
    from weaklysuperviseddl_tpu_torch.ops.cc import label_components_cuda

    t0 = time.perf_counter()
    native.load_goldens()
    build_s = time.perf_counter() - t0
    params = {k: v for k, v in CRF_REFERENCE.items() if k not in ("bilat_backend", "key_stride")}

    # ---- K2: the kernel's labels and keep-largest against the union-find ----
    cases = {"served_argmax": served_masks.to(torch.uint8)}
    for name in synthetic.FAMILIES:
        cases[name] = torch.from_numpy(synthetic.family(name, 64, (256, 256), seed=13)).cuda()
    cc = {}
    for name, masks in cases.items():
        labels = label_components_cuda(masks.contiguous()).cpu().numpy()
        kept = keep_largest_batch(masks, backend="kernel").cpu().numpy()
        host = masks.cpu().numpy()
        t0 = time.perf_counter()
        want = [(native.label_components(m), native.keep_largest(m)) for m in host]
        golden_ms = (time.perf_counter() - t0) * 1e3 / len(host)
        label_equal = sum(np.array_equal(labels[i], w[0]) for i, w in enumerate(want))
        kept_equal = sum(np.array_equal(kept[i], w[1]) for i, w in enumerate(want))
        cc[name] = {"shape": list(host.shape), "labels_equal": f"{label_equal}/{len(host)}",
                    "keep_largest_equal": f"{kept_equal}/{len(host)}",
                    "golden_ms_per_image": golden_ms}
        check(label_equal == kept_equal == len(host),
              f"K2 against the union-find on {name}: {cc[name]}")

    # ---- K3: the attention CRF on the card against the exact golden, 2 pets
    # at 64², the reference's CRF ----
    rgb, probs, unary = golden_crf_inputs(2, 64, seed=21)
    before = gaussian_filter_cuda.launches
    q = densecrf_inference(torch.from_numpy(probs).cuda(), torch.from_numpy(rgb).cuda(),
                           bilat_backend="attention", **params).cpu().numpy()
    check(gaussian_filter_cuda.launches > before, "the attention CRF did not launch K3")
    t0 = time.perf_counter()
    gold = np.stack([native.densecrf(unary[i], rgb[i], exact=True, **params)
                     for i in range(len(rgb))])
    exact_ms = (time.perf_counter() - t0) * 1e3 / len(rgb)
    mae, err = float(np.abs(q - gold).mean()), float(np.abs(q - gold).max())
    # pixels the golden leaves within 1e-3 of a tie may take either label
    sure = np.abs(gold[..., 1] - 0.5) > 1e-3
    agree_sure = float((q.argmax(-1) == gold.argmax(-1))[sure].mean())
    attention = {"shape": list(probs.shape), "mae": mae, "max_abs_err": err,
                 "argmax_agreement": float((q.argmax(-1) == gold.argmax(-1)).mean()),
                 "argmax_agreement_off_ties": agree_sure, "near_ties": int((~sure).sum()),
                 "golden_ms_per_image": exact_ms}
    check(mae < 1e-4 and agree_sure == 1.0, f"attention CRF against the exact golden: "
                                            f"{attention}")

    # ---- the lattice backend at 224² against the golden lattice CRF ----
    rgb, probs, unary = golden_crf_inputs(4, 224, seed=22)
    q = densecrf_inference(torch.from_numpy(probs).cuda(), torch.from_numpy(rgb).cuda(),
                           bilat_backend="lattice", **params).cpu().numpy()
    t0 = time.perf_counter()
    gold = np.stack([native.densecrf(unary[i], rgb[i], exact=False, **params)
                     for i in range(len(rgb))])
    lattice_ms = (time.perf_counter() - t0) * 1e3 / len(rgb)
    agree = float((q.argmax(-1) == gold.argmax(-1)).mean())
    lattice = {"shape": list(probs.shape), "argmax_agreement": agree,
               "mae": float(np.abs(q - gold).mean()), "golden_ms_per_image": lattice_ms}
    check(agree >= 0.99, f"lattice CRF against the golden lattice: {lattice}")
    emit("goldens", library=native.goldens_library_path().name, build_s=build_s,
         k2_against_union_find=cc, attention_crf_against_exact=attention,
         lattice_crf_against_golden_lattice=lattice, crf_params=params)


def cc_bound_ms(shape) -> float:
    """Least time for the labelling: one uint8 mask read + one int32 label
    written per pixel, over HBM bandwidth."""
    return float(np.prod(shape)) * (1 + 4) / HBM_BYTES_PER_S * 1e3


def reset_cc_counts():
    """The cc kernel's launch counts, in all and by plan, set to 0."""
    from weaklysuperviseddl_tpu_torch.ops.cc import label_components_cuda

    label_components_cuda.launches = 0
    label_components_cuda.plan_launches = dict.fromkeys(label_components_cuda.plan_launches, 0)


def check_cc_image_plan(path: str):
    """The path launched the cc kernel, and every launch took the one-block
    image plan (the paths' masks are 256² and 224²)."""
    from weaklysuperviseddl_tpu_torch.ops.cc import label_components_cuda as cc

    check(cc.launches > 0 and cc.plan_launches["image"] == cc.launches,
          f"{path}: cc_label launched {cc.launches} times, by plan {cc.plan_launches}; "
          "expected the image plan every time")


def phase_cc():
    import torch

    from weaklysuperviseddl_tpu_torch.masks import synthetic
    from weaklysuperviseddl_tpu_torch.masks.components import keep_largest_batch, label_components
    from weaklysuperviseddl_tpu_torch.ops.cc import label_components_cuda, plan_for

    results = []
    max_err = 0
    # the served batch, the pseudo-mask batch (both timed), a ragged shape, and
    # one too large for a block's shared memory (the tiles plan)
    for shape in ((64, 256, 256), (32, 224, 224), (3, 250, 333), (2, 512, 512)):
        plan = plan_for(*shape[1:])
        for name in synthetic.FAMILIES:
            masks = torch.from_numpy(synthetic.family(name, shape[0], shape[1:], seed=7)).cuda()
            before = label_components_cuda.plan_launches[plan]
            got = label_components_cuda(masks)
            again = label_components_cuda(masks)
            want = label_components(masks)
            torch.cuda.synchronize()
            check(label_components_cuda.plan_launches[plan] == before + 2,
                  f"cc {name} {shape} did not take the {plan} plan")
            max_err = max(max_err, int((got.long() - want.long()).abs().max()))
            check(torch.equal(got, want), f"cc labels differ from plain: {name} {shape}")
            check(torch.equal(again, got), f"cc labels differ between launches: {name} {shape}")
            kl = keep_largest_batch(masks, backend="kernel")
            check(torch.equal(kl, keep_largest_batch(masks, backend="plain")),
                  f"keep-largest differs from plain: {name} {shape}")
            row = {"family": name, "shape": list(shape), "plan": plan, "equal": True,
                   "fg_frac": round(float(masks.float().mean()), 4),
                   "components": int((got.view(shape[0], -1) == torch.arange(
                       shape[1] * shape[2], device="cuda")).sum())}
            if shape[0] in (64, 32):
                row.update(kernel_ms(lambda: label_components_cuda(masks), runs=25, warmup=3))
                row["kernel_device_ms"] = {
                    short_name(k): v
                    for k, v in device_ms(lambda: label_components_cuda(masks), runs=10)[1].items()}
                row["bound_ms"] = cc_bound_ms(shape)
            if shape[0] == 64 and name in ("blobs", "speckle"):
                row["plain_ms"] = cuda_ms(lambda: label_components(masks), runs=20, warmup=1)
                row["keep_largest_ms"] = cuda_ms(lambda: keep_largest_batch(masks))
            results.append(row)
    emit("cc", checks=results, max_abs_err=max_err, launches=label_components_cuda.launches,
         plan_launches=label_components_cuda.plan_launches, kernels=["cc_label"])
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


def serve_model():
    """The serve phase's model on the card (DeepLabV3-ResNet50 os8, 2 classes,
    seeded random weights, class-1 bias centred), the request stream it
    draws from next, and the bias shift."""
    import torch

    from weaklysuperviseddl_tpu_torch.models.deeplabv3 import DeepLabV3
    from weaklysuperviseddl_tpu_torch.models.resnet import init_weights

    rng = np.random.default_rng(0)
    model = init_weights(DeepLabV3(2, 50, 1.0), torch.Generator().manual_seed(0)).eval().cuda()
    margin = centre_classifier_bias(model, _requests(rng, 8, (256, 256)), 256)
    return model, rng, margin


def served_argmax(model, rng, size: int = 256, max_batch: int = 64):
    """The serve phase's masks before cleanup: the Predictor's argmax on a
    batch of ``max_batch`` requests drawn from ``rng``, uint8 on the card."""
    import torch

    from weaklysuperviseddl_tpu_torch.pipelines.serve import Predictor

    raw = Predictor(model, size=size, max_batch=max_batch, device="cuda")(
        _requests(rng, max_batch, (size, size)))
    return torch.from_numpy(raw).cuda()


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
    from weaklysuperviseddl_tpu_torch.ops.cc import label_components_cuda
    from weaklysuperviseddl_tpu_torch.pipelines.serve import MaskClient, MaskServer, Predictor

    size, max_batch = 256, 64
    model, rng, margin = serve_model()
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
    raw_dev = served_argmax(model, rng, size, max_batch)
    cleaned = keep_largest_batch(raw_dev, backend="kernel")
    check(torch.equal(cleaned, keep_largest_batch(raw_dev, backend="plain")),
          "keep-largest on the served argmax differs from plain")
    fg_raw, fg_clean = float(raw_dev.float().mean()), float(cleaned.float().mean())

    # ---- the main path: counts from 0, server + throughput, counts read after ----
    reset_cc_counts()
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
    check_cc_image_plan("serve")

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


def reset_qconv_counts():
    """The int8 serving path's counts (Q1, Q2 and the int32 GEMM calls) set to 0."""
    from weaklysuperviseddl_tpu_torch.ops import qconv

    for fn in (qconv.quantize_gather, qconv.dequant_epilogue, qconv.int8_gemm):
        fn.launches = 0


def qconv_counts() -> dict:
    from weaklysuperviseddl_tpu_torch.ops import qconv

    return {"quantize_gather": qconv.quantize_gather.launches,
            "dequant_epilogue": qconv.dequant_epilogue.launches,
            "int8_gemm": qconv.int8_gemm.launches}


def pets(split: str, n: int, size: int, seed: int) -> np.ndarray:
    """uint8 [n,size,size,3] synthetic pets (the CLI's calibration images)."""
    from weaklysuperviseddl_tpu_torch.data.dataset import download_data

    ds = download_data(None, split=split, synthetic_size=n, image_size=size, seed=seed)
    return np.stack([np.asarray(ds.images[i], np.uint8) for i in range(n)])


def checked_int8_forward(qmodel, x) -> dict:
    """One forward of the int8 model on ``x`` with every site's Q1, GEMM and
    Q2 call held against its plain version on the same inputs (bit-equal;
    the GEMM against a float64 product, exact at these depths) and timed at
    its shape: CUDA events and host time a call, the plain version's time,
    and each one's bound. Returns the sums over the forward's calls."""
    import torch

    import weaklysuperviseddl_tpu_torch.ops.quant as quant
    from weaklysuperviseddl_tpu_torch.ops import qconv

    sums = {name: {"calls": 0, "ms": 0.0, "host_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                   "bytes": 0.0, "ops": 0.0, "max_abs_err": 0.0}
            for name in ("quantize_gather", "int8_gemm", "dequant_epilogue")}
    real = {"quantize_gather": quant.quantize_gather, "int8_gemm": quant.int8_gemm,
            "dequant_epilogue": quant.dequant_epilogue}

    def account(name, fn, plain, nbytes, ops, bound_ms, err):
        s = sums[name]
        s["calls"] += 1
        s["ms"] += cuda_ms(fn, runs=10, warmup=2)
        s["host_ms"] += host_ms(fn, runs=10, warmup=2)
        s["plain_ms"] += cuda_ms(plain, runs=3, warmup=1)
        s["bytes"] += nbytes
        s["ops"] += ops
        s["bound_ms"] += bound_ms
        s["max_abs_err"] = max(s["max_abs_err"], err)

    def gather(xh, inv, g, Mp, Kp):
        a = real["quantize_gather"](xh, inv, g, Mp, Kp)
        want = qconv.quantize_gather_plain(xh, inv, g, Mp, Kp)
        err = float((a.int() - want.int()).abs().max())
        check(err == 0, f"quantize_gather differs from plain at {g}")
        region = xh[:, g.y0:g.y0 + g.Ho, g.x0:g.x0 + g.Wo] if g.kh == 1 and g.stride == 1 else xh
        nbytes = region.numel() * 4 + Mp * Kp
        account("quantize_gather", lambda: real["quantize_gather"](xh, inv, g, Mp, Kp),
                lambda: qconv.quantize_gather_plain(xh, inv, g, Mp, Kp), nbytes, 0,
                nbytes / HBM_BYTES_PER_S * 1e3, err)
        return a

    def gemm(a, w):
        acc = real["int8_gemm"](a, w)
        exact = (a.double() @ w.double().t()).to(torch.int32)
        check(torch.equal(acc, exact), f"int8 GEMM {tuple(a.shape)} x {tuple(w.shape)} not exact")
        (Mp, Kp), Np = a.shape, w.shape[0]
        ops, nbytes = 2.0 * Mp * Kp * Np, Mp * Kp + Np * Kp + 4.0 * Mp * Np
        account("int8_gemm", lambda: real["int8_gemm"](a, w),
                lambda: (a.double() @ w.double().t()).to(torch.int32), nbytes, ops,
                max(ops / INT8_OPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3, 0.0)
        return acc

    def epilogue(acc, rescale, bias, out, h, w, oy0=0, ox0=0, accumulate=False, norm=None):
        args = (acc, rescale, bias)
        region = (h, w, oy0, ox0, accumulate, norm)
        want = qconv.dequant_epilogue_plain(*args, out.clone(), *region)
        before = out.clone()
        real["dequant_epilogue"](*args, out, *region)
        err = float((out - want).abs().max())
        check(torch.equal(out, want), f"dequant_epilogue differs from plain ({h}x{w}, "
              f"accumulate {accumulate}, norm {norm is not None})")
        B, N = out.shape[0], out.shape[3]
        nbytes = B * h * w * N * (4 + 4 + (4 if accumulate else 0))
        scratch, plain_scratch = before.clone(), before.clone()  # timed calls write these
        account("dequant_epilogue", lambda: real["dequant_epilogue"](*args, scratch, *region),
                lambda: qconv.dequant_epilogue_plain(*args, plain_scratch, *region), nbytes, 0,
                nbytes / HBM_BYTES_PER_S * 1e3, err)
        return out

    quant.quantize_gather, quant.int8_gemm, quant.dequant_epilogue = gather, gemm, epilogue
    try:
        with torch.inference_mode():
            out = qmodel(x)
        torch.cuda.synchronize()
    finally:
        quant.quantize_gather = real["quantize_gather"]
        quant.int8_gemm = real["int8_gemm"]
        quant.dequant_epilogue = real["dequant_epilogue"]
    return out, sums


def int8_device_breakdown(qmodel, x) -> dict:
    """Device ms of one int8 forward by kind of kernel (torch.profiler), and
    the longest kernels of the "other" kind."""
    total, names = device_ms(lambda: qmodel(x), runs=2, warmup=1)

    def kind(name):
        return ("quantize_gather" if "quantize_gather" in name
                else "dequant_epilogue" if "dequant_epilogue" in name
                else "int8_gemm" if ("gemm" in name.lower() or "s8" in name) else "other")

    kinds = {"quantize_gather": 0.0, "dequant_epilogue": 0.0, "int8_gemm": 0.0, "other": 0.0}
    for name, ms in names.items():
        kinds[kind(name)] += ms
    return {"total_ms": total, **kinds,
            "top_other": sorted(((short_name(k), v) for k, v in names.items()
                                 if kind(k) == "other"), key=lambda kv: -kv[1])[:6]}


def spread(values) -> dict:
    """Median, least and largest of repeated readings."""
    return {"median": statistics.median(values), "min": min(values), "max": max(values),
            "runs": values}


def bucket_times(model, qmodel, images, size: int, max_batch: int, repeats: int = 3,
                 window_s: float = 1.0, min_images: int = 256) -> dict:
    """For every serving bucket, float32 and int8 (the path's Predictor
    settings): predict_many img/s over a window of at least ``min_images``
    images and about ``window_s`` seconds (sized from a warm-up call),
    ``repeats`` times; and the model's ms an image, ``repeats`` medians of
    CUDA events. Each as its median, least and largest reading."""
    import torch

    from weaklysuperviseddl_tpu_torch.pipelines.serve import Predictor, model_inputs

    x = model_inputs(torch.from_numpy(images[:max_batch]).cuda(), size)
    out = {}
    b = 1
    while b <= max_batch:
        row = {}
        for kind in ("fp32", "int8"):
            pred = Predictor(model, size=size, max_batch=b, clean=True, packed=True,
                             device="cuda")
            if kind == "int8":
                pred.quantized = qmodel
            pred.predict_many(images[:b])  # this batch shape's algorithms
            warm = images[:max(2 * b, 16)]
            t0 = time.perf_counter()
            pred.predict_many(warm)
            rate = len(warm) / (time.perf_counter() - t0)
            n = min(max(min_images, int(rate * window_s)), 4096)
            window = images[np.arange(-(-n // b) * b) % len(images)]
            rates, seconds = [], []
            for _ in range(repeats):
                t0 = time.perf_counter()
                pred.predict_many(window)
                seconds.append(time.perf_counter() - t0)
                rates.append(len(window) / seconds[-1])
            row[f"{kind}_img_per_s"] = spread(rates)
            row[f"{kind}_window"] = {"images": len(window), "seconds": seconds}
            m = qmodel if kind == "int8" else model
            with torch.inference_mode():
                m(x[:b])
                row[f"{kind}_model_ms_per_image"] = spread(
                    [cuda_ms(lambda: m(x[:b]), runs=3, warmup=0) / b for _ in range(repeats)])
        out[b] = row
        b *= 2
    return out


def phase_serve_int8():
    """DeepLabV3-ResNet50 at 256², max_batch 64, quantized by the port's
    int8 PTQ (calibrated on 64 synthetic pets, as the CLI without
    --calib-dir)."""
    import copy

    import torch

    from weaklysuperviseddl_tpu_torch.ops.cc import label_components_cuda
    from weaklysuperviseddl_tpu_torch.pipelines.serve import (
        MaskClient,
        MaskServer,
        Predictor,
        model_inputs,
    )

    size, max_batch = 256, 64
    model, rng, margin = serve_model()
    cpu_model = copy.deepcopy(model).cpu()
    calib = pets("test", max_batch, size, seed=0)
    evals = pets("trainval", 128, size, seed=1)

    pred = Predictor(model, size=size, max_batch=max_batch, clean=True, packed=True,
                     device="cuda")
    float_masks = pred(evals[:max_batch])
    state_file = CKPT_ROOT / "serve_int8" / "calib.json"
    state_file.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    report = pred.quantize(calib, state_path=str(state_file))
    quantize_s = time.perf_counter() - t0
    kinds = [r["kind"] for r in report.rows]
    check(len(kinds) == 77 and kinds.count("conv") == 58 and kinds.count("dot") == 19,
          f"int8 sites {len(kinds)} ({kinds.count('conv')} conv, {kinds.count('dot')} dot); "
          "expected 77 (58 conv, 19 dot)")
    qmodel = pred.quantized

    # every site's kernels against their plain versions, at the path's batch of 64
    x = model_inputs(torch.from_numpy(evals[:max_batch]).cuda(), size)
    _, per_site = checked_int8_forward(qmodel, x)
    breakdown = int8_device_breakdown(qmodel, x)

    # ---- the main path: counts from 0, predict_many and a server, counts read after ----
    reset_cc_counts()
    reset_qconv_counts()
    int8_masks = pred.predict_many(evals, in_flight=4)
    server = MaskServer(pred, max_wait_ms=5.0).start()
    try:
        client = MaskClient(f"http://127.0.0.1:{server.port}", timeout=120.0)
        served = [client.predict(img) for img in evals[:4]]
        healthz = client.healthz()
    finally:
        server.stop()
    launches = {**qconv_counts(), "cc_label": label_components_cuda.launches}
    check(all(v > 0 for v in launches.values()), f"serve_int8 launches {launches}")
    check_cc_image_plan("serve_int8")
    check(healthz["int8"] is True, "/healthz does not report int8")
    check(all(np.array_equal(m, int8_masks[i]) for i, m in enumerate(served)),
          "served int8 replies differ from predict_many's masks")
    check(int8_masks.shape == (len(evals), size, size) and set(np.unique(int8_masks)) <= {0, 1},
          "int8 masks are not binary [128,256,256]")

    # the card against the CPU port, under the same calibration file
    # (the first two rows and the last two of the first batch-64 launch)
    rows = [0, 1, max_batch - 2, max_batch - 1]
    cpu = Predictor(cpu_model, size=size, max_batch=2, clean=True, packed=True, device="cpu")
    cpu.quantize(state_path=str(state_file))
    cpu_masks = cpu.predict_many(evals[rows])
    card_cpu = float((cpu_masks == int8_masks[rows]).mean())
    check(card_cpu >= 0.995, f"int8 card/CPU mask agreement {card_cpu} < 0.995")
    agree_fp32 = float((int8_masks[:max_batch] == float_masks).mean())

    times = bucket_times(model, qmodel, evals, size, max_batch)
    profile = conv_profile(model, x)
    emit("serve_int8", model="DeepLabV3-ResNet50 os8 width 1.0, 2 classes, random init (seed 0)",
         size=size, max_batch=max_batch, bias_shift=margin, calibration="64 synthetic pets",
         sites=len(kinds), conv_sites=kinds.count("conv"), dot_sites=kinds.count("dot"),
         quantize_s=quantize_s, kernels_equal_plain=True, gemm_exact=True,
         card_cpu_int8_agreement=card_cpu, card_cpu_rows=rows, int8_fp32_agreement=agree_fp32,
         fg_frac_int8=float(int8_masks.mean()), healthz_int8=healthz["int8"],
         launches_main_path=launches, per_forward_at_batch_64=per_site,
         int8_device_ms_at_batch_64=breakdown, buckets=times, fp32_conv_profile=profile)
    return launches, per_site, breakdown


def window_pairs(window: int) -> int:
    """Pixel pairs per pixel of the window terms: inside the image the terms
    (p, o) and (p + o, -o) share their affinity and their squared difference,
    and each pair's a·d enters the gradient at p and, negated, at p + o. (The
    reflect border, counted here as interior, is 3 % of the pixels at 256²,
    window 5.)"""
    return (window * window - 1) // 2


def refine_work(B: int, H: int, W: int, C: int, window: int, steps: int, loss: str):
    """(bytes, fp32 operations) the refinement needs at the least, from its
    shapes. Bytes: S, the image and the int32 mask read once, the uint8 mask
    written once. Operations, each exp/log/div/sqrt counted as one, over the
    window_pairs P and the classes the window term needs (one at C=2: t is a
    softmax, t₁ = 1 − t₀, so d₁ = −d₀ and g₁ = −g₀):
      once per pixel: the P colour affinities (3 sub, 3 mul, 2 add, the
        exponent's mul and sub, exp: 11 each; they depend on the image only)
        and S·log S (3 per class);
      per pixel and step: softmax(X) (5C-2) and, for ncut, softmax(q) (5C-2);
        KL (5 per class); per pair and class needed d, a·d, a·d·d into the W
        sum (2) and a·d into the gradient at both ends (2): 6; the VJPs and
        the KL gradient (13 per class, +4 per class for ncut); Adam (14 per
        class)."""
    P = window_pairs(window)
    swept = 1 if C == 2 else C
    px = B * H * W
    softmaxes = (5 * C - 2) * (2 if loss == "ncut" else 1)
    per_step = (softmaxes + 5 * C + 6 * P * swept + (13 + (4 if loss == "ncut" else 0)) * C
                + 14 * C)
    ops = px * (11 * P + 3 * C + steps * per_step)
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


@contextlib.contextmanager
def dilated_aspp():
    """DeepLabV3's ASPP as dilated convolutions, not the tap plan, while the
    context lasts: the refine phase's S inputs stay the forward its gates
    were set on. The tap plan's S (the same function within float noise)
    moves pixels within 0.05 of the threshold, where K1 and the plain version
    may part by reordered float32 sums: 275 of 262,144 pixels at lr 0.1
    against 219 (0.999 allowed), none of them farther from the threshold."""
    from weaklysuperviseddl_tpu_torch.models.deeplabv3 import AtrousConv

    taps = AtrousConv.taps
    AtrousConv.taps = lambda self, H, W: None
    try:
        yield
    finally:
        AtrousConv.taps = taps


def loss_rel_err(got, want) -> float:
    return abs(float(got) - float(want)) / abs(float(want))


def phase_refine():
    import torch

    from weaklysuperviseddl_tpu_torch.models.deeplabv3 import DeepLabV3
    from weaklysuperviseddl_tpu_torch.models.resnet import init_weights
    from weaklysuperviseddl_tpu_torch.ops.refine import PLANS, TILE, refine_cuda, refine_plain

    # lr 1e-2 (the path's): a logit moves about lr per Adam step, so in 8 steps
    # no pixel can leave its one-hot start; at lr 0.2 many cross the threshold.
    # Every plan against plain; "v2" runs v1's kernel and "v2_aff" reads the
    # same affinities from stored planes, so both must give v1's masks and a
    # loss within rtol 1e-5 of v1's (bit-identical by design; counted below)
    checks, max_err, v1_bits = [], 0.0, {"v2": 0, "v2_aff": 0}
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
                        got_m, got_l = refine_cuda(*args, plan="v1", **kw)
                        again_m, again_l = refine_cuda(*args, plan="v1", **kw)
                        want_m, want_l = refine_plain(*args, **kw)
                        by_plan = {p: refine_cuda(*args, plan=p, **kw)
                                   for p in PLANS[1:] if p != "v1sym" or C == 2}
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
                        for plan, (pm, pl) in by_plan.items():
                            check(torch.equal(pm, want_m),
                                  f"refine plan {plan} masks differ from plain: {case}")
                            check(loss_rel_err(pl, want_l) <= 1e-4,
                                  f"refine plan {plan} loss off plain: {case}")
                            max_err = max(max_err, abs(float(pl) - float(want_l)))
                            if plan in v1_bits:
                                check(torch.equal(pm, got_m) and loss_rel_err(pl, got_l) <= 1e-5,
                                      f"refine plan {plan} differs from v1: {case}")
                                v1_bits[plan] += float(pl) == float(got_l)
                        checks.append({"shape": list(shape), "loss": loss, "C": C,
                                       "window": window, "lr": lr, "changed": changed,
                                       "plans": ["v1", *by_plan],
                                       "loss_rel_err": err / abs(float(want_l))})

    # the path's shape, S from DeepLabV3-ResNet50 (random weights, bias centred)
    # at the path's lr; then lr 0.1, where masks move, with random S and with
    # the model's S. Near convergence Adam steps by about lr·sign(g), so at lr
    # 0.1 a pixel whose S is near the threshold ends on the side float noise
    # picks: with the model's S (near 0.5 over wide areas) mismatches are
    # allowed only there. v1 and v1sym against plain, v2_aff against v1.
    # The S inputs keep the ASPP's dilated convolutions (dilated_aspp).
    model = init_weights(DeepLabV3(2, 50, 1.0), torch.Generator().manual_seed(1)).eval().cuda()
    with dilated_aspp():
        centre_classifier_bias(model, _requests(np.random.default_rng(1), 4, (256, 256)), 256)
        S, x, masks = synthetic_path_batch(model, 4, 256, seed=5)
        S8, x8, masks8 = synthetic_path_batch(model, 8, 256, seed=6)
    rng = np.random.default_rng(9)
    S_rand = rng.uniform(0.1, 1, tuple(S.shape)).astype(np.float32)
    S_rand = torch.from_numpy(S_rand / S_rand.sum(-1, keepdims=True)).cuda()
    path = {}
    # ---- v2_aff's main path: its count from 0, the full-width runs, read after ----
    refine_cuda.plan_launches = dict.fromkeys(PLANS, 0)
    for name, S_case, lr in (("model_S_lr_0.01", S, 1e-2), ("random_S_lr_0.1", S_rand, 0.1),
                             ("model_S_lr_0.1", S, 0.1)):
        want_m, want_l = refine_plain(S_case, x, masks, lr=lr)
        near = (S_case[..., 1] - 0.5).abs()
        path[name] = {"px_with_S_within_0.05_of_threshold": int((near <= 0.05).sum())}
        runs = {}
        for plan in ("v1", "v1sym", "v2_aff"):
            got_m, got_l = refine_cuda(S_case, x, masks, lr=lr, plan=plan)
            again_m, again_l = refine_cuda(S_case, x, masks, lr=lr, plan=plan)
            torch.cuda.synchronize()
            runs[plan] = (got_m, got_l)
            check(torch.equal(again_m, got_m) and float(again_l) == float(got_l),
                  f"refine {plan} differs between launches at [4,256,256], {name}")
            agree = float((got_m == want_m).float().mean())
            err = abs(float(got_l) - float(want_l))
            max_err = max(max_err, err)
            far_mismatch = int(((got_m != want_m) & (near > 0.05)).sum())
            if name == "model_S_lr_0.1":
                check(agree >= 0.999 and far_mismatch == 0,
                      f"refine {plan} masks differ away from the threshold at [4,256,256], "
                      f"{name}: agreement {agree}, {far_mismatch} px with |S-0.5| > 0.05")
            else:
                check(agree >= 0.9999,
                      f"refine {plan} mask agreement {agree} < 0.9999 at [4,256,256], {name}")
            check(err <= 1e-4 * abs(float(want_l)),
                  f"refine {plan} loss off at [4,256,256], {name}: {err}")
            changed = float((got_m != masks).float().mean())
            check(lr < 0.05 or changed > 0.01, f"refine moved no mask at [4,256,256], {name}")
            path[name][plan] = {"mask_agreement": agree,
                                "mismatched_px": int((got_m != want_m).sum()),
                                "mismatched_px_far_from_threshold": far_mismatch,
                                "changed_frac": changed, "loss": float(got_l),
                                "loss_rel_err": err / abs(float(want_l))}
        (v1_m, v1_l), (aff_m, aff_l) = runs["v1"], runs["v2_aff"]
        aff_agree = float((aff_m == v1_m).float().mean())
        check(aff_agree >= 0.9999 and torch.equal(aff_m, v1_m) and
              loss_rel_err(aff_l, v1_l) <= 1e-5,
              f"refine v2_aff differs from v1 at [4,256,256], {name}: agreement {aff_agree}")
        path[name]["v2_aff_vs_v1"] = {"mask_agreement": aff_agree,
                                      "loss_bit_identical": float(aff_l) == float(v1_l)}
    aff_launches = refine_cuda.plan_launches["v2_aff"]
    check(aff_launches > 0, "the full-width runs never launched plan v2_aff")

    # every plan's time at three configurations: the ncut path's [4,256,256]
    # (C=2, 20 steps), scripts/bench_refine_plans.py's [8,256,256] (10 steps),
    # and the boundary protocol's [4,256,256] (75 steps, lambda 0.5, sigma_space 10)
    boundary_kw = dict(loss="boundary", num_steps=75, lambda_boundary=0.5, sigma_space=10.0)
    configs = {"ncut_4x256_20_steps": ((S, x, masks), {}, (4, 256, 256), 20, "ncut"),
               "ncut_8x256_10_steps": ((S8, x8, masks8), {"num_steps": 10}, (8, 256, 256), 10,
                                       "ncut"),
               "boundary_4x256_75_steps": ((S, x, masks), boundary_kw, (4, 256, 256), 75,
                                           "boundary")}
    # "v2" runs v1's kernel (ops/refine.py), so its time is v1's and is not
    # taken apart; ms by CUDA events around a call, the profiler's summed
    # kernel time and its split by kernel beside it
    timed_plans = [p for p in PLANS if p != "v2"]
    plan_ms, plan_device_ms, plan_kernels = {}, {}, {}
    for cname, (inputs, kw, shape, steps, loss) in configs.items():
        times, dev_times, kernels = {}, {}, {}
        for plan in timed_plans:
            fn = lambda: refine_cuda(*inputs, plan=plan, **kw)
            times[plan] = cuda_ms(fn, runs=25)
            dev_times[plan], by_kernel = device_ms(fn, runs=5)
            kernels[plan] = {}
            for k, ms in by_kernel.items():
                kernels[plan][short_name(k)] = kernels[plan].get(short_name(k), 0.0) + ms
        bound_ms, bound_by, _ = refine_bound(shape, 2, 5, steps, loss)
        plan_ms[cname] = {**times, "fastest": min(times, key=times.get),
                          "fastest_by_device_ms": min(dev_times, key=lambda p: dev_times[p] or 0),
                          "bound_ms": bound_ms, "bound_by": bound_by}
        plan_device_ms[cname] = dev_times
        plan_kernels[cname] = kernels

    shape = tuple(masks.shape)
    bound_ms, bound_by, ops = refine_bound(shape, 2, 5, 20, "ncut")
    # the edge phase's pixels as the kernel counts them per tile: every pixel
    # within pad of an edge (the frame of width pad + 1), and no other
    B, H, W = shape
    edge_px = torch.full((B, -(-H // TILE), -(-W // TILE)), -1, dtype=torch.int32, device="cuda")
    refine_cuda(S, x, masks, edge_pixels=edge_px)
    pad = 5 // 2
    frame = H * W - (H - 2 * (pad + 1)) * (W - 2 * (pad + 1))
    check(int(edge_px.sum()) == B * frame and int(edge_px.min()) >= 0,
          f"the edge phase took {int(edge_px.sum())} pixels, not the {B * frame} near an edge")
    by_steps = {n: cuda_ms(lambda: refine_cuda(S, x, masks, num_steps=n), runs=10)
                for n in (0, 10)}
    auto = kernel_ms(lambda: refine_cuda(S, x, masks), runs=10)  # "auto" = v1sym at C=2
    timing = {
        "ms": plan_ms["ncut_4x256_20_steps"]["v1sym"],
        "back_to_back_ms": auto["back_to_back_ms"], "device_ms": auto["device_ms"],
        "ms_v1": plan_ms["ncut_4x256_20_steps"]["v1"],
        "ms_v2_aff": plan_ms["ncut_4x256_20_steps"]["v2_aff"],
        "device_ms_v2_aff": plan_device_ms["ncut_4x256_20_steps"]["v2_aff"],
        "back_to_back_ms_v2_aff": kernel_ms(lambda: refine_cuda(S, x, masks, plan="v2_aff"),
                                            runs=10)["back_to_back_ms"],
        # the wrapper's host time per call (40 launches a call: 10 calls stay
        # inside the launch queue)
        "host_ms": host_ms(lambda: refine_cuda(S, x, masks), runs=10),
        "host_ms_v2_aff": host_ms(lambda: refine_cuda(S, x, masks, plan="v2_aff"), runs=10),
        "plain_ms": cuda_ms(lambda: refine_plain(S, x, masks), runs=5, warmup=1),
        "bound_ms": bound_ms, "bound_by": bound_by, "gflop": ops / 1e9,
        "ms_at_0_and_10_steps": by_steps,
        "max_abs_err": max_err, "shape": list(shape), "C": 2, "window": 5,
        "steps": 20, "loss": "ncut", "v2_aff_launches": aff_launches,
        "bound_share": bound_ms / plan_ms["ncut_4x256_20_steps"]["v1sym"],
        "interior_tile_share": float((edge_px == 0).float().mean()),  # counted by the kernel
        "edge_pixel_share": float(edge_px.sum()) / (B * H * W),
    }
    emit("refine", checks=len(checks), small_shapes_equal=True,
         small_max_loss_rel_err=max(c["loss_rel_err"] for c in checks),
         small_min_changed_at_lr_0_2=min(c["changed"] for c in checks if c["lr"] > 0.1),
         small_loss_bit_identical_to_v1=v1_bits,
         path_cases=path, fg_frac_before=float(masks.float().mean()),
         plan_ms=plan_ms, plan_v2="runs v1's kernel: its ms is v1's",
         plan_device_ms=plan_device_ms, plan_kernel_ms=plan_kernels,
         launches_main_path={"v2_aff": aff_launches},
         kernels=["refine", "refine_v2_aff"], **timing)
    return timing, (S, x, masks), (S8, x8)


def window_work(B: int, H: int, W: int, C: int, window: int, backward: bool):
    """(bytes, fp32 operations) the window sum, or its gradient, needs at the
    least, from its shapes. Bytes: probs and the image read once and,
    backward, the gradient written once. Operations over the window_pairs P
    (every class: probs need not sum to 1): each pair's affinity (11, as
    refine_work counts them) and per pair and class 3 (d, a·d, a·d·d into the
    sum) or 4 (d, a·d, and a·d into the gradient at both ends); backward also
    2 per pixel and class (the factor 2·g)."""
    P = window_pairs(window)
    px = B * H * W
    ops = px * (11 * P + (4 if backward else 3) * P * C + (2 * C if backward else 0))
    nbytes = px * 4 * (C + 3 + (C if backward else 0))
    return nbytes, ops


def autograd_refinement(S, images, masks, num_steps=20, lr=1e-2, loss="ncut",
                        lambda_boundary=0.1, sigma_color=0.1, sigma_space=5.0, window_size=5):
    """One image's refinement written as a user of the window kernels would
    write it: Adam on X under torch.autograd, the window term through
    fused_local_normalized_cut_loss (ncut: it softmaxes q again, as the
    reference's criterion does) or fused_boundary_loss, one forward and one
    backward kernel per step. Returns (uint8 mask, summed step loss, each
    step's (q, W))."""
    import torch

    from weaklysuperviseddl_tpu_torch.ops.window import (
        fused_boundary_loss,
        fused_local_normalized_cut_loss,
    )

    x = torch.nn.functional.one_hot(masks.long(), S.shape[-1]).float().requires_grad_(True)
    opt = torch.optim.Adam([x], lr=lr)
    s_log_s = torch.where(S > 0, S * torch.log(torch.where(S > 0, S, torch.ones_like(S))),
                          torch.zeros_like(S)).sum()
    total = torch.zeros((), device=S.device)
    trace = []
    for _ in range(num_steps):
        q = torch.softmax(x, dim=-1)
        kl = s_log_s - (S * torch.log(q + 1e-8)).sum()
        if loss == "ncut":
            w = fused_local_normalized_cut_loss(q, images, sigma_color, window_size)
        else:
            w = fused_boundary_loss(q, images, sigma_color, sigma_space, window_size)
        step_loss = kl + lambda_boundary * kl.detach() / (w.detach() + 1e-6) * w
        opt.zero_grad()
        step_loss.backward()
        opt.step()
        total = total + step_loss.detach()
        trace.append((q.detach(), w.detach()))
    return (torch.softmax(x.detach(), dim=-1)[..., 1] > 0.5).to(torch.uint8), total, trace


def phase_window(path_batch, batch8):
    import torch

    from weaklysuperviseddl_tpu_torch.losses.window import boundary_loss, local_normalized_cut_loss
    from weaklysuperviseddl_tpu_torch.ops.refine import refine_cuda, refine_plain
    from weaklysuperviseddl_tpu_torch.ops.window import (
        fused_boundary_loss,
        fused_local_normalized_cut_loss,
        window_sum_cuda,
        window_sum_grad_cuda,
        window_sum_grad_plain,
        window_sum_plain,
    )

    def value_and_grad(fn, x):
        p = x.clone().requires_grad_(True)
        value = fn(p)
        value.backward()
        return value.detach(), p.grad

    # the fuzz shapes of tests/test_fuzz_kernels.py (random inputs), then the
    # full width: the refinement's [8,256,256,2] on synthetic pets (S from
    # DeepLabV3, the normalised images), both losses at the refinement's sigmas
    S8, x8 = batch8
    cases, err = [], {"value": 0.0, "grad": 0.0}
    for B, H, W, C, ws in ((2, 11, 13, 2, 3), (2, 16, 24, 3, 5), (2, 9, 32, 2, 7),
                           (8, 256, 256, 2, 5)):
        if H == 256:
            preds, images, sc, ss = S8, x8, 0.1, 5.0
        else:
            rng = np.random.default_rng(H * W + C + ws)
            preds = torch.from_numpy(rng.standard_normal((B, H, W, C)).astype(np.float32)).cuda()
            images = torch.from_numpy(rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32)).cuda()
            sc, ss = 0.07, 4.0
        for loss in ("ncut", "boundary"):
            if loss == "ncut":
                x = preds
                fused = lambda p: fused_local_normalized_cut_loss(p, images, sc, ws)
                plain = lambda p: local_normalized_cut_loss(p, images, sc, ws)
            else:
                x = torch.softmax(preds, -1)
                fused = lambda p: fused_boundary_loss(p, images, 0.1, ss, ws)
                plain = lambda p: boundary_loss(p, images, 0.1, ss, ws)
            got, got_g = value_and_grad(fused, x)
            again, again_g = value_and_grad(fused, x)
            want, want_g = value_and_grad(plain, x)
            torch.cuda.synchronize()
            case = f"[{B},{H},{W},{C}] window {ws} {loss}"
            check(torch.allclose(got, want, rtol=1e-5, atol=0),
                  f"window loss differs from plain: {case}: {float(got)} vs {float(want)}")
            check(torch.allclose(got_g, want_g, rtol=1e-4, atol=1e-7),
                  f"window gradient differs from plain: {case}")
            check(torch.equal(again, got) and torch.equal(again_g, got_g),
                  f"window kernels differ between launches: {case}")
            e_v, e_g = float((got - want).abs()), float((got_g - want_g).abs().max())
            err = {"value": max(err["value"], e_v), "grad": max(err["grad"], e_g)}
            row = {"case": case, "value": float(got), "value_abs_err": e_v,
                   "value_rel_err": e_v / abs(float(want)), "grad_max_abs_err": e_g,
                   "grad_max": float(want_g.abs().max())}
            if H == 256:
                # the normalised gradient is ~1e-8 here, inside atol 1e-7: hold
                # the raw sum's gradient to plain relative to its largest entry
                probs = torch.softmax(x, -1).contiguous() if loss == "ncut" else x
                sigmas = (sc, None) if loss == "ncut" else (0.1, ss)
                kg = window_sum_grad_cuda(probs, images, *sigmas, ws)
                pg = window_sum_grad_plain(probs, images, *sigmas, ws)
                row["raw_grad_err_over_max"] = float((kg - pg).abs().max() / pg.abs().max())
                check(row["raw_grad_err_over_max"] <= 1e-4,
                      f"window raw-sum gradient differs from plain: {case}: {row}")
            cases.append(row)

    # the kernels alone at full width: ncut on t = softmax(S) (what the
    # refinement's window term sees), and boundary on S
    t8 = torch.softmax(S8, -1).contiguous()
    nbytes, ops = window_work(8, 256, 256, 2, 5, False)
    fwd_bound, fwd_by = roofline(nbytes, ops)
    nbytes_b, ops_b = window_work(8, 256, 256, 2, 5, True)
    bwd_bound, bwd_by = roofline(nbytes_b, ops_b)
    fwd = kernel_ms(lambda: window_sum_cuda(t8, x8, 0.1, None, 5), runs=50, warmup=5)
    bwd = kernel_ms(lambda: window_sum_grad_cuda(t8, x8, 0.1, None, 5), runs=50, warmup=5)
    _, fwd_kernels = device_ms(lambda: window_sum_cuda(t8, x8, 0.1, None, 5), runs=20)
    timing = {
        "fwd": fwd, "fwd_kernel_device_ms": {short_name(k): v for k, v in fwd_kernels.items()},
        "bwd": bwd,
        "fwd_plain_ms": cuda_ms(lambda: window_sum_plain(t8, x8, 0.1, None, 5), runs=10),
        "bwd_plain_ms": cuda_ms(lambda: window_sum_grad_plain(t8, x8, 0.1, None, 5), runs=10),
        "boundary_fwd": kernel_ms(lambda: window_sum_cuda(S8, x8, 0.1, 5.0, 5), runs=50,
                                  warmup=5),
        "boundary_bwd": kernel_ms(lambda: window_sum_grad_cuda(S8, x8, 0.1, 5.0, 5), runs=50,
                                  warmup=5),
        # the wrappers' host time per call (calls in a row, nothing waited for)
        "fwd_host_ms": host_ms(lambda: window_sum_cuda(t8, x8, 0.1, None, 5), runs=50),
        "bwd_host_ms": host_ms(lambda: window_sum_grad_cuda(t8, x8, 0.1, None, 5), runs=50),
        "fwd_bound_ms": fwd_bound, "fwd_bound_by": fwd_by, "fwd_gflop": ops / 1e9,
        "bwd_bound_ms": bwd_bound, "bwd_bound_by": bwd_by, "bwd_gflop": ops_b / 1e9,
        "shape": [8, 256, 256, 2], "window": 5,
    }

    # ---- the main path: counts from 0, one image's refinement under autograd
    # through the window kernels where masks move, counts read after: ncut at
    # lr 0.1 for 20 steps on random S (as the refine phase's case), and the
    # boundary protocol (lr 1e-2, 75 steps, lambda 0.5, sigma_space 10) on S
    # that says the pet (0.9 inside, 0.1 outside) with the mask shifted 8 px
    # off it, as a CAM pseudo-mask sits off the object. At the ncut path's lr
    # 1e-2 no pixel leaves its one-hot start in 20 steps; nor does it in the
    # boundary protocol where every mask edge lies on a colour edge (W ≈ 0
    # makes λ huge), so equal masks would show nothing there ----
    _, x, masks = (t[:1].contiguous() for t in path_batch)
    rng = np.random.default_rng(11)
    S_rand = rng.uniform(0.1, 1, (1, 256, 256, 2)).astype(np.float32)
    S_rand = torch.from_numpy(S_rand / S_rand.sum(-1, keepdims=True)).cuda()
    p_pet = torch.where(masks == 1, 0.9, 0.1).float()
    S_pet = torch.stack([1 - p_pet, p_pet], -1).contiguous()
    path_cases = {
        "ncut_lr_0.1_20_steps": (S_rand, masks, dict(num_steps=20, lr=0.1)),
        "boundary_protocol_75_steps": (S_pet, torch.roll(masks, 8, dims=2).contiguous(),
                                       dict(num_steps=75, lr=1e-2, loss="boundary",
                                            lambda_boundary=0.5, sigma_space=10.0)),
    }
    window_sum_cuda.launches = 0
    window_sum_grad_cuda.launches = 0
    runs = {name: autograd_refinement(S_case, x, m0, **kw)
            for name, (S_case, m0, kw) in path_cases.items()}
    torch.cuda.synchronize()
    launches = {"window_fwd": window_sum_cuda.launches,
                "window_bwd": window_sum_grad_cuda.launches}
    steps = sum(kw["num_steps"] for _, _, kw in path_cases.values())
    check(launches == {"window_fwd": steps, "window_bwd": steps},
          f"the autograd refinements launched the window kernels {launches} times, not {steps}")
    path = {}
    for name, (S_case, m0, kw) in path_cases.items():
        got_m, got_l, trace = runs[name]
        want_m, want_l = refine_plain(S_case, x, m0, **kw)
        # each step's W from the kernel against the plain loss on the same q
        # (rtol 1e-5; atol 1e-12, far below the ~1e-7 of a moving W: at step 0
        # W underflows to 0 where every mask edge lies on a colour edge)
        w_err = 0.0
        for step, (q, w) in enumerate(trace):
            if kw.get("loss", "ncut") == "ncut":
                plain_w = float(local_normalized_cut_loss(q, x, 0.1, 5))
            else:
                plain_w = float(boundary_loss(q, x, 0.1, kw["sigma_space"], 5))
            diff = abs(float(w) - plain_w)
            check(diff <= 1e-5 * abs(plain_w) + 1e-12,
                  f"autograd refinement {name}: step {step}'s W {float(w)} off plain {plain_w}")
            w_err = max(w_err, diff / abs(plain_w) if plain_w else 0.0)
        # as the refine phase's path cases: where S is within 0.05 of the
        # threshold, Adam's last steps of about lr leave a pixel on the side
        # float noise picks
        near = (S_case[..., 1] - 0.5).abs() <= 0.05
        agree = float((got_m == want_m).float().mean())
        far = int(((got_m != want_m) & ~near).sum())
        changed = float((got_m != m0).float().mean())
        check(changed > 0.01, f"autograd refinement {name} moved {changed} of the mask")
        check(agree >= 0.9999 and far == 0,
              f"autograd refinement {name} masks differ from refine_plain's: agreement {agree}, "
              f"{far} px with |S-0.5| > 0.05")
        check(loss_rel_err(got_l, want_l) <= 1e-4,
              f"autograd refinement {name} loss {float(got_l)} off refine_plain's "
              f"{float(want_l)}")
        ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            autograd_refinement(S_case, x, m0, **kw)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        path[name] = {"shape": [1, 256, 256, 2], **kw, "changed_frac": changed,
                      "mask_agreement": agree, "mismatched_px": int((got_m != want_m).sum()),
                      "loss_rel_err": loss_rel_err(got_l, want_l), "step_w_max_rel_err": w_err,
                      "ms": statistics.median(ms),
                      "k1_auto": kernel_ms(lambda: refine_cuda(S_case, x, m0, **kw), runs=10)}
    emit("window", cases=cases, value_rtol=1e-5, grad_rtol=1e-4, grad_atol=1e-7,
         max_abs_err=err, autograd_refinements=path, launches_main_path=launches,
         kernels=["window_fwd", "window_bwd"], **timing)
    return {**timing, "launches": launches, "max_abs_err": err}


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
    ckpt_dir = CKPT_ROOT / "weakly"
    # ---- the main path: counts from 0, the pipeline, counts read after ----
    reset_cc_counts()
    refine_cuda.launches = 0
    refine_cuda.plan_launches = dict.fromkeys(refine_cuda.plan_launches, 0)
    t0 = time.perf_counter()
    result = run_weakly_supervised_alternating(cfg, checkpoint_dir=str(ckpt_dir), stopwatch=sw,
                                               log=lambda *_: None, device="cuda")
    wall = time.perf_counter() - t0
    launches = {"refine": refine_cuda.launches, "cc_label": label_components_cuda.launches}
    plans = dict(refine_cuda.plan_launches)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    n_train = len(result.mask_store)
    want_refine = math.ceil(n_train / cfg.seg.batch_size) * 2 * 2
    check(launches["refine"] == want_refine,
          f"refine launched {launches['refine']} times on the main path, expected {want_refine}")
    check(plans["v1sym"] == want_refine, f"plan 'auto' ran {plans} at C=2, not v1sym")
    check(launches["cc_label"] > 0, "the main path never launched the cc kernel")
    check_cc_image_plan("weakly")
    m = result.metrics
    scalars = {k: m[k] for k in ("iou", "acc", "final_loss", "alt_iou", "alt_acc")}
    check(all(math.isfinite(v) for v in scalars.values()), f"non-finite metrics {scalars}")
    check(len(m["trajectory"]) == 2, "one trajectory entry per alternation")
    images, masks, _ = result.mask_store.as_arrays()
    check(masks.shape == (n_train, 256, 256) and set(np.unique(masks)) <= {0, 1},
          "refined store masks are not binary [N,256,256]")
    # the last snapshot holds the run's final state, bit for bit; the final
    # model is kept for the serve_checkpoint phase before the checks below train it
    check(sorted(p.name for p in ckpt_dir.iterdir()) == ["alt_000", "alt_001"],
          f"snapshots {sorted(p.name for p in ckpt_dir.iterdir())}, expected alt_000, alt_001")
    check_snapshot_equals(ckpt_dir / "alt_001", seg_state_snapshot(result.seg_state),
                          result.mask_store, "weakly's last snapshot")
    final_model = copy.deepcopy(result.seg_state.model).eval()

    # ---- a refinement sweep of two batches, the card against the CPU, same
    # weights: at the path's lr (masks cannot move) and at lr 0.1 (they do);
    # on the card the first batch warms the sweep up and the second is a
    # replay of its graph ----
    model = result.seg_state.model.eval()
    cpu_model = copy.deepcopy(model).cpu()
    table = torch.arange(8).view(2, 4)
    agree = {}
    for lr in (r.lr, 0.1):
        rl = dataclasses.replace(r, lr=lr)
        dev_masks = torch.from_numpy(masks[:8]).cuda()
        cpu_masks = dev_masks.cpu().clone()
        make_refine_sweep(model, rl, 256)(dev_masks, torch.from_numpy(images[:8]).cuda(),
                                          table.cuda())
        check(make_refine_sweep(model, rl, 256).graph is not None, "the sweep was not graphed")
        make_refine_sweep(cpu_model, rl, 256)(cpu_masks, torch.from_numpy(images[:8]), table)
        agree[str(lr)] = {"agreement": float((dev_masks.cpu() == cpu_masks).float().mean()),
                          "changed_frac": float((cpu_masks.numpy() != masks[:8]).mean())}
        check(agree[str(lr)]["agreement"] >= 0.995,
              f"card/CPU refinement-sweep agreement {agree[str(lr)]} < 0.995 at lr {lr}")
    step_ms = seg_step_breakdown(result.seg_state, images[:4], masks[:4])
    dispatch = graphed_dispatch(result.seg_state.model, images, masks)
    dispatch["sweep"] = sweep_dispatch(result.seg_state.model, r, images, masks)

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
         launches_main_path=launches, refine_plans_main_path=plans,
         card_cpu_sweep_agreement=agree,
         store_fg_frac=float(masks.mean()), seg_step_ms=step_ms, dispatch=dispatch,
         checkpoint={"dir_entries": ["alt_000", "alt_001"],
                     "snapshot_mb": snapshot_mb(ckpt_dir / "alt_000"),
                     "seconds_per_snapshot": sw.times["checkpoint"] / sw.counts["checkpoint"]})
    return launches, {"cfg": cfg, "ckpt_dir": ckpt_dir, "masks": masks, "metrics": m,
                      "final_model": final_model}


def seg_state_snapshot(state) -> dict:
    """A CPU copy of a seg train state: the model's state dict, the optimizer's
    moments and counters, step."""
    opt = state.optimizer
    return {"model": {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()},
            "m": [t.cpu().clone() for t in opt.m], "v": [t.cpu().clone() for t in opt.v],
            "counters": (int(opt.count), int(opt.notfinite_count), int(opt.total_notfinite),
                         state.step)}


def check_snapshot_equals(alt_dir, want: dict, store, what: str):
    """The snapshot files of ``alt_dir``, read back with torch.load and
    np.load, bit-equal to ``want`` (``seg_state_snapshot``) and ``store``."""
    import torch

    tree = torch.load(alt_dir / "state.pt", map_location="cpu", weights_only=True)
    opt = tree["optimizer"]
    check(tree["model"].keys() == want["model"].keys(), f"{what}: model keys differ")
    check(all(torch.equal(tree["model"][k], v) for k, v in want["model"].items()),
          f"{what}: the model's state dict differs")
    check(len(opt["m"]) == len(want["m"]) and len(opt["v"]) == len(want["v"])
          and all(torch.equal(a, b) for a, b in zip(opt["m"] + opt["v"], want["m"] + want["v"])),
          f"{what}: Adam's moments differ")
    counters = (int(opt["count"]), int(opt["notfinite_count"]), int(opt["total_notfinite"]),
                tree["step"])
    check(counters == want["counters"], f"{what}: counters {counters} != {want['counters']}")
    images, masks, keys = store.as_arrays()
    with np.load(alt_dir / "masks.npz", allow_pickle=False) as z:
        check(z["keys"].tolist() == keys and np.array_equal(z["masks"], masks)
              and np.array_equal(z["images"], images), f"{what}: the mask store differs")


def snapshot_mb(alt_dir) -> float:
    return sum(f.stat().st_size for f in alt_dir.iterdir()) / 2**20


def phase_weakly_boundary():
    import copy
    import dataclasses
    import math
    from unittest import mock

    import torch

    from weaklysuperviseddl_tpu_torch.config import ExperimentConfig, apply_overrides
    from weaklysuperviseddl_tpu_torch.ops.cc import label_components_cuda
    from weaklysuperviseddl_tpu_torch.ops.refine import refine_cuda
    from weaklysuperviseddl_tpu_torch.pipelines import weakly
    from weaklysuperviseddl_tpu_torch.pipelines.weakly import run_weakly_supervised_alternating
    from weaklysuperviseddl_tpu_torch.train import alternating
    from weaklysuperviseddl_tpu_torch.utils.profiling import Stopwatch

    # the reference's boundary-loss protocol (AlternatingDirectionBoundaryLoss.py
    # :153-206; the JAX compat surface's values), as the CLI's dotted overrides
    protocol = {"alternating.refine.loss": "boundary", "alternating.refine.num_steps": "75",
                "alternating.refine.lambda_boundary": "0.5",
                "alternating.refine.sigma_space": "10", "alternating.refine_repeats": "1",
                "mask.cam_thresh": "0.5"}
    cuts = {"classifier.epochs": 2, "seg.epochs": 1, "alternating.num_alternations": 1,
            "alternating.epochs_per_round": 1}
    cfg = apply_overrides(ExperimentConfig(), {**protocol, **{k: str(v) for k, v in cuts.items()}})
    base, r = ExperimentConfig(), cfg.alternating.refine
    check((r.loss, r.num_steps, r.lambda_boundary, r.sigma_color, r.sigma_space, r.threshold,
           r.lr, r.window_size, cfg.alternating.refine_repeats, cfg.mask.cam_thresh) ==
          ("boundary", 75, 0.5, 0.1, 10.0, 0.5, 1e-2, 5, 1, 0.5),
          f"weakly_boundary config is not the reference's protocol: {r}")
    check(cfg.data == base.data and cfg.cam == base.cam
          and cfg.seg == dataclasses.replace(base.seg, epochs=1)
          and cfg.classifier == dataclasses.replace(base.classifier, epochs=2)
          and cfg.mask == dataclasses.replace(base.mask, cam_thresh=0.5),
          "weakly_boundary config cut more than depth")

    # the masks of the run's one upload of the store (stage 4 trains on it and
    # the alternating loop continues on it), kept to count the pixels the
    # refinement changes (outside every timed phase; with one round and one
    # sweep, nothing else writes the masks)
    uploaded = []
    upload = alternating.upload_store_resident

    def recording_upload(store, seg_size=256, device=None):
        out = upload(store, seg_size, device)
        uploaded.append(out[1].cpu().numpy())
        return out

    sw = Stopwatch("cuda")
    torch.cuda.reset_peak_memory_stats()
    # ---- the main path: counts from 0, the pipeline, counts read after ----
    reset_cc_counts()
    refine_cuda.launches = 0
    refine_cuda.plan_launches = dict.fromkeys(refine_cuda.plan_launches, 0)
    t0 = time.perf_counter()
    with mock.patch.object(alternating, "upload_store_resident", recording_upload), \
            mock.patch.object(weakly, "upload_store_resident", recording_upload):
        result = run_weakly_supervised_alternating(cfg, stopwatch=sw, log=lambda *_: None,
                                                   device="cuda")
    wall = time.perf_counter() - t0
    launches = {"refine": refine_cuda.launches, "cc_label": label_components_cuda.launches}
    plans = dict(refine_cuda.plan_launches)
    n_train = len(result.mask_store)
    want_refine = math.ceil(n_train / cfg.seg.batch_size)
    check(launches["refine"] == want_refine and plans["v1sym"] == want_refine,
          f"refine launched {launches['refine']} times ({plans}) on the boundary path, "
          f"expected {want_refine}, all v1sym")
    check(launches["cc_label"] > 0, "the boundary path never launched the cc kernel")
    check_cc_image_plan("weakly_boundary")
    m = result.metrics
    scalars = {k: m[k] for k in ("iou", "acc", "final_loss", "alt_iou", "alt_acc")}
    check(all(math.isfinite(v) for v in scalars.values()), f"non-finite metrics {scalars}")
    images, masks, _ = result.mask_store.as_arrays()
    check(len(uploaded) == 1 and uploaded[0].shape == masks.shape,
          f"{len(uploaded)} uploads of the store, expected 1 of shape {masks.shape}")
    changed = float((masks != uploaded[0]).mean())

    # ---- one refinement batch of 1 image, the card against the CPU, same weights ----
    model = result.seg_state.model.eval()
    cpu_model = copy.deepcopy(model).cpu()
    table = torch.zeros((1, 1), dtype=torch.int64)
    dev_masks = torch.from_numpy(masks[:1]).cuda()
    cpu_masks = dev_masks.cpu().clone()
    alternating.make_refine_sweep(model, r, 256)(dev_masks, torch.from_numpy(images[:1]).cuda(),
                                                 table.cuda())
    alternating.make_refine_sweep(cpu_model, r, 256)(cpu_masks, torch.from_numpy(images[:1]),
                                                     table)
    agree = float((dev_masks.cpu() == cpu_masks).float().mean())
    check(agree >= 0.995, f"card/CPU boundary refinement agreement {agree} < 0.995")

    phases = {name: {"seconds": sw.times[name], "calls": sw.counts[name],
                     "img_per_s": sw.rate(name)} for name in sw.times}
    emit("weakly_boundary", entry="run_weakly_supervised_alternating",
         overrides=protocol, cuts=cuts, train_images=n_train, wall_s=wall, phases=phases,
         metrics=m, peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
         launches_main_path=launches, refine_plans_main_path=plans,
         refine_changed_frac=changed,
         card_cpu_refine_agreement={"agreement": agree, "images": 1,
                                    "changed_frac_cpu": float((cpu_masks.numpy() != masks[:1])
                                                              .mean())},
         store_fg_frac=float(masks.mean()))
    return launches


def seg_step_breakdown(state, images, masks) -> dict:
    """Device ms of the parts of one eager segmentation training step at
    batch 4 (after the main path; it trains the model further): gather +
    preprocess, forward + loss, backward, the guarded Adam update (its
    decision and exact select on the device), and the whole step; and the
    sweep's forward and kernel per batch."""
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


def state_distance(a, b, start) -> dict:
    """How far two seg train states lie apart after the same steps from
    ``start`` (a list of the parameters before them): the largest absolute
    difference of a parameter, and the L2 distance of all parameters over
    the L2 length of ``a``'s way from ``start``; whether every parameter,
    buffer (BatchNorm statistics, the dropout key), moment and counter is
    bit-equal, and the step counts too."""
    import torch

    pa, pb = list(a.model.parameters()), list(b.model.parameters())
    tensors = lambda st: [*st.model.parameters(), *st.model.buffers(),  # noqa: E731
                          *st.optimizer.m, *st.optimizer.v, st.optimizer.count,
                          st.optimizer.notfinite_count, st.optimizer.total_notfinite]
    with torch.no_grad():
        diff = torch.cat([(x - y).reshape(-1).float() for x, y in zip(pa, pb)])
        way = torch.cat([(x - s).reshape(-1).float() for x, s in zip(pa, start)])
        return {"max_abs": float(diff.abs().max()),
                "rel_l2": float(diff.norm() / way.norm().clamp(min=1e-30)),
                "bit_equal": a.step == b.step and all(
                    same_bits(x, y) for x, y in zip(tensors(a), tensors(b)))}


def same_bits(x, y) -> bool:
    """Whether two tensors hold the same bytes (a NaN equals the same NaN:
    a step on a NaN batch leaves NaN BatchNorm statistics, as in JAX)."""
    import torch

    return x.shape == y.shape and x.dtype == y.dtype and torch.equal(
        x.reshape(-1).contiguous().view(torch.uint8), y.reshape(-1).contiguous().view(torch.uint8))


def eager_epoch(state, images, masks, seed: int, batch: int = 4, seg_size: int = 256,
                watch: int | None = None):
    """One epoch as train_segmentation_model orders it (its permutation, its
    padded tail, its dropout keys), step by step through the public eager
    ``seg_train_step``. ``watch``: the step whose parameters and moments are
    returned as they were before and after it."""
    import torch

    from weaklysuperviseddl_tpu_torch.models.deeplabv3 import seed_dropout
    from weaklysuperviseddl_tpu_torch.train.segmentation import (
        _prep,
        dropout_seed,
        seg_train_step,
    )

    n = images.shape[0]
    order = np.random.default_rng(seed).permutation(n)
    snap = lambda: [t.detach().clone() for t in (*state.model.parameters(),  # noqa: E731
                                        *state.optimizer.m, *state.optimizer.v)]
    watched = None
    for t in range(-(-n // batch)):
        idx = order[t * batch:(t + 1) * batch]
        nv = len(idx)
        idx = np.concatenate([idx, np.repeat(idx[-1], batch - nv)])
        idx_t = torch.from_numpy(idx).to(images.device)
        x, m = _prep(images[idx_t], masks[idx_t], seg_size)
        valid = torch.arange(batch, device=images.device) < nv
        seed_dropout(state.model, dropout_seed(seed + 1, 0, t))
        before = snap() if t == watch else None
        seg_train_step(state, x, m, valid)
        if t == watch:
            watched = (before, snap())
    return watched


def step_dispatch_times(state, images, masks, K: int, B: int) -> dict:
    """One seg train state's training step at batch B, 256², eager
    (seg_train_step: events, device and host ms) and graphed (chunks of K
    steps through train_segmentation_model: ms a step, the capture's seconds,
    the first call's, peak and reserved GB, a chunk replayed under sync-debug
    mode "error", the graphed epoch's img/s over 3 epochs of ``images``)."""
    import torch

    from weaklysuperviseddl_tpu_torch.train.segmentation import (
        _epoch_programs,
        _epoch_table,
        _prep,
        _stage,
        dropout_seed,
        seg_train_step,
        train_segmentation_model,
    )

    N = len(images)
    quiet = lambda *_: None  # noqa: E731
    x, mm = _prep(images[:B], masks[:B], 256)
    valid = torch.ones(B, dtype=torch.bool, device="cuda")
    eager_step = lambda: seg_train_step(state, x, mm, valid)  # noqa: E731
    eager = {"events_ms": cuda_ms(eager_step, runs=5, warmup=1),
             "device_ms": device_ms(eager_step, runs=2, warmup=1)[0],
             "host_ms": host_ms(eager_step, runs=3, warmup=1)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    train_segmentation_model(state, images, masks, num_epochs=1, batch_size=B,
                             seg_size=256, seed=0, log=quiet)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    prog = _epoch_programs(state, images, masks, B, 256, "cross_entropy", K)
    check(set(prog.graphs) == {K}, f"graphs {sorted(prog.graphs)} after one full-chunk epoch")
    rows = _stage(_epoch_table([np.arange(t * B, (t + 1) * B) for t in range(K)], B,
                               [dropout_seed(1, 0, t) for t in range(K)]),
                  torch.device("cuda"))
    chunk = lambda: prog.run(rows, state, images, masks)  # noqa: E731
    graphed = {"events_ms": cuda_ms(chunk, runs=5, warmup=1) / K,
               "device_ms": device_ms(chunk, runs=2, warmup=0)[0] / K,
               "host_ms": host_ms(chunk, runs=10, warmup=1) / K,
               "capture_s": prog.capture_seconds[K], "first_call_s": first_s,
               "peak_gb": torch.cuda.max_memory_allocated() / 2**30,
               "reserved_gb": torch.cuda.memory_reserved() / 2**30,
               "before_gb": base_gb}
    # a chunk with no host synchronisation in it: the copy of its rows
    # and the replay under sync-debug mode "error"
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        chunk()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    graphed["sync_free_chunk"] = True
    # epochs through the entry point: img/s of the graphed loop
    t0 = time.perf_counter()
    train_segmentation_model(state, images, masks, num_epochs=3, batch_size=B,
                             seg_size=256, seed=1, log=quiet)
    torch.cuda.synchronize()
    graphed["epoch_img_per_s"] = 3 * N / (time.perf_counter() - t0)
    return {"eager": eager, "graphed": graphed,
            "events_speedup": eager["events_ms"] / graphed["events_ms"]}


def graphed_dispatch(seg_model, store_images, store_masks) -> dict:
    """The training chunk as a CUDA graph against the eager seg_train_step,
    DeepLabV3-R50 at 256², batch 4, K = 8 (train_segmentation_model's
    default), from the cycle's trained weights: per step events ms, device ms
    and host ms, the capture's seconds and peak GB, in float32 and bfloat16;
    a chunk replayed under sync-debug mode "error"; the graphed epoch at K = 8
    and K = 1 against eager loops of seg_train_step, bit for bit under
    cudnn.deterministic, and a planted stale dropout key that must fail that
    gate; a NaN batch inside a chunk, bit for bit against the eager loop."""
    import copy

    import torch

    from weaklysuperviseddl_tpu_torch.models.deeplabv3 import DeepLabV3
    from weaklysuperviseddl_tpu_torch.train.guard import GuardedAdam
    from weaklysuperviseddl_tpu_torch.train.segmentation import (
        SegTrainState,
        train_segmentation_model,
    )

    K, B, N = 8, 4, 32
    images = torch.from_numpy(store_images[:N]).cuda()
    masks = torch.from_numpy(store_masks[:N]).cuda()
    quiet = lambda *_: None  # noqa: E731
    out = {"K": K, "batch": B, "images": N}

    def fresh(dtype):
        model = DeepLabV3(2, 50, 1.0, dtype=dtype).cuda()
        model.load_state_dict(seg_model.state_dict())
        return SegTrainState(model, GuardedAdam(model.parameters(), lr=1e-4))

    # ---- timing, float32 and bfloat16 ----
    for dtype in ("float32", "bfloat16"):
        out[dtype] = step_dispatch_times(fresh(dtype), images, masks, K, B)
        torch.cuda.empty_cache()

    # ---- the graphed epoch against eager loops, from one state, under
    # cudnn.deterministic (and DeepLabV3's upsample without atomics): 9 steps,
    # a chunk of 8 and a half-valid tail step. Two eager loops, the graphed
    # epoch at K = 8 and at K = 1 must all give the same bits: parameters,
    # BatchNorm statistics, the dropout key, Adam's moments and counters. A
    # graphed run whose staged dropout seeds are all step 0's (a stale key)
    # must fail that gate ----
    from weaklysuperviseddl_tpu_torch.train import segmentation

    n_bits = N + 2
    images = torch.from_numpy(store_images[:n_bits]).cuda()
    masks = torch.from_numpy(store_masks[:n_bits]).cuda()
    start = fresh("float32")
    before = [p.detach().clone() for p in start.model.parameters()]
    counters = lambda st: [int(st.optimizer.count), int(st.optimizer.notfinite_count),  # noqa: E731
                           int(st.optimizer.total_notfinite), st.step]
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = {}
        for name in ("eager_a", "eager_b"):
            runs[name] = copy.deepcopy(start)
            eager_epoch(runs[name], images, masks, seed=5)
        for name, k in (("graphed_k8", K), ("graphed_k1", 1)):
            runs[name] = copy.deepcopy(start)
            train_segmentation_model(runs[name], images, masks, num_epochs=1, batch_size=B,
                                     seg_size=256, seed=5, steps_per_dispatch=k, log=quiet)
        planted = copy.deepcopy(start)
        true_seed = segmentation.dropout_seed
        segmentation.dropout_seed = lambda s, e, t: true_seed(s, e, 0)
        try:
            train_segmentation_model(planted, images, masks, num_epochs=1, batch_size=B,
                                     seg_size=256, seed=5, log=quiet)
        finally:
            segmentation.dropout_seed = true_seed
        steps = {k: counters(v) for k, v in runs.items()}
        check(all(c == [9, 0, 0, 9] for c in steps.values()), f"counters {steps}")
        got = {k: state_distance(runs[k], runs["eager_a"], before)
               for k in ("eager_b", "graphed_k8", "graphed_k1")}
        for k, d in got.items():
            check(d["bit_equal"], f"{k} is not bit-equal to an eager loop: {got}")
        fault = state_distance(planted, runs["eager_a"], before)
        check(not fault["bit_equal"], "a stale dropout key in the graph passed the gate")
        out["bits"] = {"cudnn_deterministic": True, "steps": 9, "against": "eager_a", **got,
                       "planted_stale_dropout_key": {**fault, "gate_failed": True}}
        del runs, planted

        # ---- a NaN batch inside a graphed chunk: float images, the first
        # row of step 3 all NaN; the eager loop shows the step keeps
        # parameters and moments, and the graphed epoch equals it bit for bit ----
        seed = 7
        poisoned = images[:N].float() / 255.0
        order = np.random.default_rng(seed).permutation(N)
        poisoned[int(order[3 * B])] = float("nan")
        eager = copy.deepcopy(start)
        watched = eager_epoch(eager, poisoned, masks[:N], seed=seed, watch=3)
        held = all(torch.equal(a, b) for a, b in zip(*watched))
        check(held, "the eager step on the NaN batch changed parameters or moments")
        graphed = copy.deepcopy(start)
        train_segmentation_model(graphed, poisoned, masks[:N], num_epochs=1, batch_size=B,
                                 seg_size=256, seed=seed, log=quiet)
        check(counters(graphed) == counters(eager) == [K - 1, 0, 1, K],
              f"counters after a NaN step: graphed {counters(graphed)}, eager {counters(eager)}")
        nan_dist = state_distance(graphed, eager, before)
        check(nan_dist["bit_equal"], f"graphed chunk with a NaN step {nan_dist} is not the "
                                     "eager loop's bits")
    finally:
        torch.backends.cudnn.deterministic = old
    # a chunk of NaN steps only (the buffer refilled in place), under the
    # default math flags: a second program of this state, captured while the
    # first stays cached; parameters, moments and Adam's count bit for bit.
    # The copies are detached: a clone in autograd's graph would keep the
    # parameters' gradient accumulators alive on the default stream, which a
    # capture on another stream cannot wait on
    kept = [t.detach().clone() for t in (*graphed.model.parameters(), *graphed.optimizer.m,
                                         *graphed.optimizer.v, graphed.optimizer.count)]
    poisoned.fill_(float("nan"))
    train_segmentation_model(graphed, poisoned, masks[:N], num_epochs=1, batch_size=B,
                             seg_size=256, seed=seed, log=quiet)
    now = (*graphed.model.parameters(), *graphed.optimizer.m, *graphed.optimizer.v,
           graphed.optimizer.count)
    check(all(torch.equal(a, b) for a, b in zip(kept, now)),
          "a chunk of NaN steps changed parameters, moments or Adam's count")
    check(counters(graphed) == [K - 1, K, K + 1, 2 * K],
          f"counters after a NaN chunk: {counters(graphed)}")
    out["nan_step"] = {"position": "step 3 of a chunk of 8", "eager_held": held,
                       "counters": counters(graphed), "graphed_vs_eager": nan_dist,
                       "nan_chunk_held": True}
    return out


def sweep_dispatch(seg_model, cfg, store_images, store_masks) -> dict:
    """The refinement sweep's ms per batch of 4 at 256²: replays of its
    captured graph (make_refine_sweep) against the same batches op by op."""
    import torch

    from weaklysuperviseddl_tpu_torch.train.alternating import _sweep_batch, make_refine_sweep

    B, T = 4, 8
    images = torch.from_numpy(store_images[:B * T]).cuda()
    masks = torch.from_numpy(store_masks[:B * T]).cuda()
    table = torch.arange(B * T, device="cuda").view(T, B)
    model = seg_model.eval()
    sweep = make_refine_sweep(model, cfg, 256)
    graphed = lambda: sweep(masks, images, table)  # noqa: E731
    # the first call warms up and captures the graph: what its pool keeps
    torch.cuda.synchronize()
    before = torch.cuda.memory_reserved(), torch.cuda.memory_allocated()
    graphed()
    torch.cuda.synchronize()
    pool = {"reserved_gb": (torch.cuda.memory_reserved() - before[0]) / 2**30,
            "allocated_gb": (torch.cuda.memory_allocated() - before[1]) / 2**30}

    def eager():
        acc = torch.zeros((), device="cuda")
        with torch.no_grad():
            for idx in table:
                _sweep_batch(model, cfg, 256, masks, images, idx, acc)

    return {"batches": T, "batch": B,
            "graphed_ms_per_batch": cuda_ms(graphed, runs=3, warmup=1) / T,
            "eager_ms_per_batch": cuda_ms(eager, runs=3, warmup=1) / T,
            "graphed_host_ms_per_batch": host_ms(graphed, runs=3, warmup=1) / T,
            "eager_host_ms_per_batch": host_ms(eager, runs=1, warmup=1) / T,
            "capture_s": sweep.graph.capture_seconds, "graph_memory_added": pool}


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
    check(fp64_rel <= 1e-4, f"bilateral off the float64 sum at reference magnitudes: {fp64_rel}")

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
        **kernel_ms(lambda: gaussian_filter_cuda(fq, fk, v), runs=10, warmup=2),
        "host_ms": host_ms(lambda: gaussian_filter_cuda(fq, fk, v), runs=10),
        "back_to_back_ms_under_profiler": events_under_profiler_ms(
            lambda: gaussian_filter_cuda(fq, fk, v)),
        "ms_C1": kernel_ms(lambda: gaussian_filter_cuda(fq, fk, norm_v), runs=10, warmup=2)["ms"],
        "plain_ms": cuda_ms(lambda: gaussian_filter_plain_cross(fq, fk, v), runs=2, warmup=1),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_ms_C1": roofline(*bilateral_work(*shape[:4], 1))[0],
        "gflop": bilateral_work(*shape)[1] / 1e9,
        "max_abs_err": path_err, "shape": shape,
    }
    timing["bound_share"] = bound_ms / timing["ms"]
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


def cam_fusion_inputs():
    """The full-width classifier (seed 0), 32 synthetic pets at 224² and
    their labels, and the classifier's own layer3 and layer4 activations and
    gradients, [32,1024,14,14] and [32,2048,14,14], as layercam takes them
    and ops/cam_fusion.cam_fusion hands them to the kernel (contiguous:
    cuDNN may return channels-last memory): (model, x, cls, acts, grads)."""
    import torch

    from weaklysuperviseddl_tpu_torch.data.preprocess import preprocess_batch
    from weaklysuperviseddl_tpu_torch.data.synthetic import synthetic_pet_arrays

    model = full_width_classifier(0)
    images, labels, _ = synthetic_pet_arrays(32, image_size=224, seed=8)
    x, _ = preprocess_batch(torch.from_numpy((images * 255).astype(np.uint8)).cuda(), None,
                            size=224)
    cls = torch.from_numpy(labels).cuda()
    xi = x.permute(0, 3, 1, 2).detach().requires_grad_(True)
    logits, feats = model.features(xi)
    acts = [feats["layer3"], feats["layer4"]]
    grads = torch.autograd.grad(logits.gather(1, cls.long().view(-1, 1)).sum(), acts)
    return (model, x, cls, [a.detach().contiguous() for a in acts],
            [g.contiguous() for g in grads])


def phase_cam_fusion():
    import torch

    from weaklysuperviseddl_tpu_torch.cam.layercam import layercam
    from weaklysuperviseddl_tpu_torch.ops.cam_fusion import (
        cam_fusion_cuda,
        cam_fusion_plain,
        cluster_size,
        max_active_clusters,
        sm_count,
    )

    model, x, cls, acts, grads = cam_fusion_inputs()
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
        B, C, h, w = a.shape
        # the CTAs of an image's cluster, and how many such clusters the card
        # holds at once (the occupancy query the kernel runs before its first
        # launch of a shape)
        S = cluster_size(B, C, sm_count(a.device))
        clusters = max_active_clusters(C, h * w, S, (h * w) % 4 == 0)
        cases.append({"name": name, "shape": list(a.shape), "max_abs_err": err,
                      "cluster_size": S, "max_active_clusters": clusters})
        if name != "ragged":
            max_err = max(max_err, err)
            # bytes: act and grad read once, the CAM written once; operations:
            # a multiply, a max and an add per element
            bound_ms, bound_by = roofline(4 * B * h * w * (2 * C + 1), 3 * B * C * h * w)
            by_shape[name] = {
                "shape": list(a.shape), "cluster_size": S,
                **kernel_ms(lambda: cam_fusion_cuda(a, g), runs=50, warmup=5),
                "host_ms": host_ms(lambda: cam_fusion_cuda(a, g), runs=50),
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
    emit("cam_fusion", cases=cases, by_shape=by_shape, layercam_max_abs_err=layercam_err,
         layercam_ms={f: cuda_ms(lambda: layercam(model, x, cls, output_size=224, fusion=f),
                                 runs=3, warmup=1) for f in ("pallas", "xla")},
         launches_main_path=launches, kernels=["cam_fusion"])
    return {"launches": launches, "max_abs_err": max_err, **by_shape["layer4"]}


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
    for kernel in (gaussian_filter_cuda, cam_fusion_cuda, refine_cuda):
        kernel.launches = 0
    reset_cc_counts()
    refine_cuda.plan_launches = dict.fromkeys(refine_cuda.plan_launches, 0)
    t0 = time.perf_counter()
    result = run_weakly_supervised_alternating(cfg, stopwatch=sw, log=lambda *_: None,
                                               device="cuda")
    wall = time.perf_counter() - t0
    launches = {"bilateral": gaussian_filter_cuda.launches, "cam_fusion": cam_fusion_cuda.launches,
                "cc_label": label_components_cuda.launches, "refine": refine_cuda.launches}
    plans = dict(refine_cuda.plan_launches)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    n_train = len(result.mask_store)
    want_k3 = math.ceil(n_train / d.batch_size) * (1 + m.crf_iters)
    check(launches["bilateral"] == want_k3,
          f"bilateral launched {launches['bilateral']} times on the path, expected {want_k3}")
    check(launches["cc_label"] > 0 and launches["refine"] > 0,
          f"the CRF path did not launch cc_label and refine: {launches}")
    check(launches["cam_fusion"] == 0, "fusion='auto' launched the cam_fusion kernel")
    check_cc_image_plan("weakly_crf")
    check(plans["v1sym"] == launches["refine"], f"plan 'auto' ran {plans} at C=2, not v1sym")
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
    # the plain CRF on the host's CPU takes about 40 s per image at 224²: one
    # image (the kernel is held to the plain filter on the card on all 32)
    cpu1 = ResidentCams(resident.images_raw[:1].cpu(), resident.cams[:1].cpu(),
                        resident.store_images[:1].cpu(), resident.image_size, 1)
    t_cpu = time.perf_counter()
    cpu_masks = crf_masks(cpu1)
    cpu_s = time.perf_counter() - t_cpu
    cpu_agree = float((kernel_masks[:1] == cpu_masks).mean())
    check(cpu_agree >= 0.999, f"CRF masks, card vs CPU on 1 image: {cpu_agree}")
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
         refine_plans_main_path=plans, expected_bilateral_launches=want_k3,
         masks_kernel_vs_plain_agreement=plain_agree, masks_card_vs_cpu_agreement=cpu_agree,
         cpu_crf_1_image_s=cpu_s,
         subsampled_vs_attention={"mean": float(per_image.mean()),
                                  "min": float(per_image.min())},
         crf_fg_frac=fg, batch32_ms=batch_ms)
    return launches


def reset_refine_counts():
    from weaklysuperviseddl_tpu_torch.ops.refine import refine_cuda

    refine_cuda.launches = 0
    refine_cuda.plan_launches = dict.fromkeys(refine_cuda.plan_launches, 0)


def phase_weakly_resume(weakly):
    import math
    from unittest import mock

    import torch

    from weaklysuperviseddl_tpu_torch.ops.cc import label_components_cuda
    from weaklysuperviseddl_tpu_torch.ops.refine import refine_cuda
    from weaklysuperviseddl_tpu_torch.pipelines import weakly as pipeline
    from weaklysuperviseddl_tpu_torch.utils.profiling import Stopwatch

    cfg = weakly["cfg"]
    # exactly what a run stopped after its first alternation leaves behind
    resume_dir = CKPT_ROOT / "resume"
    shutil.copytree(weakly["ckpt_dir"] / "alt_000", resume_dir / "alt_000")
    restored, logs = [], []
    restore = pipeline.restore_alternation

    def recording_restore(root, state, iteration=None):
        out = restore(root, state, iteration)
        restored.append((seg_state_snapshot(out[0]), out[1], out[2]))
        return out

    sw = Stopwatch("cuda")
    # ---- the main path: counts from 0, the resumed pipeline, counts read after ----
    reset_cc_counts()
    reset_refine_counts()
    t0 = time.perf_counter()
    with mock.patch.object(pipeline, "restore_alternation", recording_restore):
        result = pipeline.run_weakly_supervised_alternating(
            cfg, checkpoint_dir=str(resume_dir), resume=True, stopwatch=sw, log=logs.append,
            device="cuda")
    wall = time.perf_counter() - t0
    launches = {"refine": refine_cuda.launches, "cc_label": label_components_cuda.launches}
    plans = dict(refine_cuda.plan_launches)
    n_train = len(result.mask_store)
    alt = cfg.alternating
    want_refine = math.ceil(n_train / cfg.seg.batch_size) * alt.refine_repeats * (
        alt.num_alternations - 1)
    check(launches["refine"] == want_refine and plans["v1sym"] == want_refine,
          f"refine launched {launches['refine']} times ({plans}) in the continuation, "
          f"expected {want_refine}, all v1sym")
    check(any("Resumed from" in s and "alternation 1" in s for s in logs),
          "the run did not resume at alternation 1")
    check(len(restored) == 1 and restored[0][2] == 1, "one restore, of alternation 0")
    check_snapshot_equals(weakly["ckpt_dir"] / "alt_000", restored[0][0], restored[0][1],
                          "the restored state against alt_000")
    check(sorted(p.name for p in resume_dir.iterdir()) == ["alt_000", "alt_001"],
          "the continuation did not snapshot alternation 1")
    m = result.metrics
    check(all(math.isfinite(m[k]) for k in ("alt_iou", "alt_acc")), f"non-finite metrics {m}")
    check([t["alternation"] for t in m["trajectory"]] == [2], f"trajectory {m['trajectory']}")
    _, masks, _ = result.mask_store.as_arrays()
    check(masks.shape == weakly["masks"].shape, "the resumed store has another shape")
    agree = float((masks == weakly["masks"]).mean())
    # cuDNN's backward is not bitwise deterministic: bit equality is reported
    check(agree >= 0.995, f"resumed final masks agree {agree} < 0.995 with the uninterrupted run")
    phases = {name: {"seconds": sw.times[name], "calls": sw.counts[name],
                     "img_per_s": sw.rate(name)} for name in sw.times}
    deterministic = deterministic_resume_pair(cfg)
    emit("weakly_resume", entry="run_weakly_supervised_alternating(resume=True)",
         resumed_from="a copy of the weakly phase's alt_000", cuts="as weakly; alternation 1 "
         "of 2 (alternation 0 restored)", train_images=n_train, wall_s=wall, phases=phases,
         launches_main_path=launches, refine_plans_main_path=plans,
         restored_state_bit_equal_to_alt_000=True,
         final_masks_agreement=agree, final_masks_bit_equal=bool(np.array_equal(
             masks, weakly["masks"])),
         alt_iou={"resumed": m["alt_iou"], "uninterrupted": weakly["metrics"]["alt_iou"]},
         snapshot_mb=snapshot_mb(resume_dir / "alt_001"),
         checkpoint_s=sw.times["checkpoint"],
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
         deterministic_pair=deterministic)
    return launches


def deterministic_resume_pair(cfg) -> dict:
    """Resume held to the bits: under cudnn.deterministic, an uninterrupted
    run_weakly_supervised_alternating at two alternations and a resume from a
    copy of its alt_000 must end with the same final masks, the same
    segmentation state (parameters, BatchNorm statistics, Adam's moments and
    counters, step) and the same alt_iou, bit for bit. ``cfg`` (weakly's) is
    cut in pets, classifier epochs and sweeps; the widths stay."""
    import math

    import torch

    from weaklysuperviseddl_tpu_torch.config import apply_overrides
    from weaklysuperviseddl_tpu_torch.pipelines.weakly import run_weakly_supervised_alternating

    cut = {"data.synthetic_size": 32, "classifier.epochs": 1, "alternating.refine_repeats": 1}
    cfg = apply_overrides(cfg, cut)
    check(cfg.alternating.num_alternations == 2, "the pair needs two alternations")
    root = CKPT_ROOT / "deterministic"
    quiet = lambda *_: None  # noqa: E731
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    t0 = time.perf_counter()
    try:
        full = run_weakly_supervised_alternating(cfg, checkpoint_dir=str(root / "full"),
                                                 log=quiet, device="cuda")
        shutil.copytree(root / "full" / "alt_000", root / "resumed" / "alt_000")
        resumed = run_weakly_supervised_alternating(cfg, checkpoint_dir=str(root / "resumed"),
                                                    resume=True, log=quiet, device="cuda")
    finally:
        torch.backends.cudnn.deterministic = old
    wall = time.perf_counter() - t0
    a, b = seg_state_snapshot(full.seg_state), seg_state_snapshot(resumed.seg_state)
    differ = [k for k in a["model"] if k not in b["model"]
              or not same_bits(a["model"][k], b["model"][k])]
    moments_equal = len(a["m"]) == len(b["m"]) and all(
        same_bits(x, y) for x, y in zip(a["m"] + a["v"], b["m"] + b["v"]))
    _, masks_a, keys_a = full.mask_store.as_arrays()
    _, masks_b, keys_b = resumed.mask_store.as_arrays()
    iou_a, iou_b = full.metrics["alt_iou"], resumed.metrics["alt_iou"]
    out = {"cudnn_deterministic": True, "cut": cut, "train_images": len(full.mask_store),
           "wall_s": wall,
           "final_masks_bit_equal": keys_a == keys_b and np.array_equal(masks_a, masks_b),
           "final_masks_agreement": float((masks_a == masks_b).mean()),
           "model_state_bit_equal": a["model"].keys() == b["model"].keys() and not differ,
           "model_tensors_differing": len(differ),
           "adam_moments_bit_equal": moments_equal,
           "counters": {"uninterrupted": a["counters"], "resumed": b["counters"]},
           "alt_iou": {"uninterrupted": iou_a, "resumed": iou_b}}
    out["alt_iou_bit_equal"] = iou_a == iou_b or (math.isnan(iou_a) and math.isnan(iou_b))
    shutil.rmtree(root)
    for key in ("final_masks_bit_equal", "model_state_bit_equal", "adam_moments_bit_equal",
                "alt_iou_bit_equal"):
        check(out[key], f"deterministic resume: {key} is false: {out}")
    check(a["counters"] == b["counters"], f"deterministic resume: counters {out['counters']}")
    return out


def phase_serve_checkpoint(weakly):
    from weaklysuperviseddl_tpu_torch.cli import serve_model
    from weaklysuperviseddl_tpu_torch.ops.cc import label_components_cuda
    from weaklysuperviseddl_tpu_torch.pipelines.serve import Predictor

    size, batch = 256, 64
    state_file = weakly["ckpt_dir"] / "alt_001" / "state.pt"
    t0 = time.perf_counter()
    loaded = serve_model(smoke=False, checkpoint=str(state_file))  # the CLI's loader
    load_s = time.perf_counter() - t0
    try:
        serve_model(smoke=True, checkpoint=str(state_file))
        refused = False
    except ValueError as e:
        refused = "do not fit" in str(e)
    check(refused, "a ResNet-50 state loaded into the smoke ResNet-18 without an error")
    from_file = Predictor(loaded, size=size, max_batch=batch, clean=True, packed=True,
                          device="cuda")
    in_memory = Predictor(weakly["final_model"], size=size, max_batch=batch, clean=True,
                          packed=True, device="cuda")
    reqs = _requests(np.random.default_rng(8), batch, (size, size))
    calib = pets("test", batch, size, seed=0)
    # ---- the path: counts from 0, one batch through each Predictor, then the
    # snapshot quantized as the CLI's serve does, counts read after ----
    reset_cc_counts()
    reset_qconv_counts()
    got = from_file(reqs)
    want = in_memory(reqs)
    from_file.quantize(calib)
    got_int8 = from_file(reqs)
    launches = {"cc_label": label_components_cuda.launches, **qconv_counts()}
    check(all(v > 0 for v in launches.values()), f"serve_checkpoint launches {launches}")
    check(got_int8.shape == got.shape and set(np.unique(got_int8)) <= {0, 1},
          "int8 masks served from the checkpoint are not binary [64,256,256]")
    check_cc_image_plan("serve_checkpoint")
    check(got.shape == (batch, size, size) and set(np.unique(got)) <= {0, 1},
          "masks served from the checkpoint are not binary [64,256,256]")
    check(np.array_equal(got, want),
          "masks served from the snapshot differ from the in-memory model's")
    emit("serve_checkpoint", entry="cli.serve_model(checkpoint=alt_001/state.pt) + "
         "Predictor(clean=True, packed=True)", batch=batch, size=size, load_s=load_s,
         masks_equal=True, fg_frac=float(got.mean()), wrong_model_refused=refused,
         int8_fp32_agreement=float((got_int8 == got).mean()), fg_frac_int8=float(got_int8.mean()),
         launches_main_path=launches)
    return launches


def phase_supervised():
    import copy
    import math
    from unittest import mock

    import torch

    from weaklysuperviseddl_tpu_torch.config import ExperimentConfig
    from weaklysuperviseddl_tpu_torch.pipelines import supervised
    from weaklysuperviseddl_tpu_torch.train.segmentation import evaluate_multiclass_dataset

    cfg = ExperimentConfig()
    cuts = {"num_epochs": 1, "test_runs": 1}  # of seg.epochs 5 and the reference's 3
    seconds, n_train = {"train": [], "eval": []}, []

    def timed_call(name, fn):
        def wrapped(*args, **kw):
            if name == "train":
                n_train.append(len(args[1]))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            seconds[name].append(time.perf_counter() - t0)
            return out
        return wrapped

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with mock.patch.object(supervised, "train_segmentation_model",
                           timed_call("train", supervised.train_segmentation_model)), \
            mock.patch.object(supervised, "evaluate_multiclass_dataset",
                              timed_call("eval", supervised.evaluate_multiclass_dataset)):
        state, metrics = supervised.run_supervised_training(cfg, log=lambda *_: None,
                                                            device="cuda", **cuts)
    wall = time.perf_counter() - t0
    check(all(math.isfinite(v) for v in metrics.values())
          and all(0.0 <= metrics[k] <= 1.0 for k in ("acc_mean", "iou_mean")),
          f"supervised metrics {metrics}")
    check(len(seconds["eval"]) == 2, "one validation and one test evaluation")
    # the epoch's validation runs inside the training call
    train_s = seconds["train"][0] - seconds["eval"][0]

    # evaluate_multiclass_dataset on the card against the same weights on the CPU
    images, trimaps = supervised.load_test_arrays(cfg, "cuda")
    images, trimaps = images[:16], trimaps[:16]
    kw = dict(num_classes=2, batch_size=cfg.data.eval_batch_size, seg_size=cfg.data.seg_size)
    card = evaluate_multiclass_dataset(state.model, images, trimaps, **kw)
    cpu = evaluate_multiclass_dataset(copy.deepcopy(state.model).cpu(), images.cpu(),
                                      trimaps.cpu(), **kw)
    check(abs(card[0] - cpu[0]) <= 0.005 and abs(card[1] - cpu[1]) <= 0.005,
          f"card (acc, iou) {card} against the CPU's {cpu}: more than 0.005 apart")
    emit("supervised", entry="run_supervised_training",
         model="DeepLabV3-ResNet50 os8 (2 classes, 256², batch 4), random init (seed 0)",
         cuts=cuts, train_images=n_train[0], wall_s=wall, metrics=metrics,
         train_s=train_s, train_img_per_s=n_train[0] / train_s,
         eval_s={"validation": seconds["eval"][0], "test": seconds["eval"][1]},
         card_cpu_eval={"images": 16, "card": card, "cpu": cpu},
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)


def phase_ablations():
    import math
    from unittest import mock

    import torch

    from weaklysuperviseddl_tpu_torch.config import ExperimentConfig, SegConfig
    from weaklysuperviseddl_tpu_torch.masks.components import keep_largest_batch
    from weaklysuperviseddl_tpu_torch.masks.pseudo import cam_to_mask
    from weaklysuperviseddl_tpu_torch.ops.cc import label_components_cuda
    from weaklysuperviseddl_tpu_torch.pipelines import ablations
    from weaklysuperviseddl_tpu_torch.pipelines.weakly import build_classifier
    from weaklysuperviseddl_tpu_torch.train.segmentation import _EPOCH_PROGRAMS

    cfg = ExperimentConfig(seg=SegConfig(epochs=1))
    grid, repeats = ablations.default_grid()[:1], 2
    cuts = {"grid": "the first of default_grid()'s 12 points", "num_repeats": repeats,
            "seg.epochs": 1}
    classifier = build_classifier(cfg, "cuda")  # untrained, as the CLI's
    residents, stores, run_s = [], [], []
    extract, derive, run = ablations.extract_cams, ablations.masks_from_cams, ablations.run_ablation

    def recording_extract(*args, **kw):
        residents.append(extract(*args, **kw))
        return residents[-1]

    def recording_derive(resident, **kw):
        stores.append((derive(resident, **kw), kw))
        return stores[-1][0]

    def timed_run(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(*args, **kw)
        torch.cuda.synchronize()
        run_s.append(time.perf_counter() - t0)
        return out

    # ---- the main path: counts from 0, the grid, counts read after ----
    reset_cc_counts()
    t0 = time.perf_counter()
    with mock.patch.object(ablations, "extract_cams", recording_extract), \
            mock.patch.object(ablations, "masks_from_cams", recording_derive), \
            mock.patch.object(ablations, "run_ablation", timed_run):
        results = ablations.run_ablation_experiment(grid, classifier, cfg, num_repeats=repeats,
                                                    log=lambda *_: None)
    wall = time.perf_counter() - t0
    launches = {"cc_label": label_components_cuda.launches}
    # what the grid's states leave on the card: each run's captured graphs go
    # with its optimizer
    gc.collect()
    after_grid = {"allocated_gb": torch.cuda.memory_allocated() / 2**30,
                  "reserved_gb": torch.cuda.memory_reserved() / 2**30,
                  "epoch_programs_cached": len(_EPOCH_PROGRAMS)}
    check_cc_image_plan("ablations")
    check(len(residents) == 1 and len(stores) == repeats, "CAMs once, masks once per run")
    resident = residents[0]
    want = repeats * math.ceil(min(len(resident), cfg.mask.max_images) / resident.batch_size)
    check(launches["cc_label"] == want, f"cc_label launched {launches['cc_label']} times, "
          f"expected {want}")
    # the path's masks (keep-largest by the kernel) against the plain keep-largest
    # of the same thresholded CAMs, in the run's order
    removed = []
    for store, kw in stores:
        idx = torch.from_numpy(kw["order"][:kw["max_images"]]).cuda()
        thresholded = cam_to_mask(resident.cams[idx], kw["cam_thresh"], keep_largest_masks=False)
        plain = keep_largest_batch(thresholded, backend="plain")
        check(np.array_equal(plain.cpu().numpy(), store.as_arrays()[1]),
              "the grid's keep-largest masks differ from the plain keep-largest")
        removed.append(float((thresholded != plain).float().mean()))
    runs = [r for r in results if "run_id" in r]
    summary = results[-1]
    check(len(runs) == repeats and "iou_mean" in summary, f"{len(runs)} runs, summary {summary}")
    check(all(math.isfinite(r[k]) for r in runs for k in ("iou", "acc", "final_loss")),
          f"non-finite run results {runs}")
    emit("ablations", entry="run_ablation_experiment",
         models="CamClassifier ResNet-50 (37 classes, 224², untrained, seed 0); DeepLabV3-"
                "ResNet50 os8 (256², batch 4) per run, seeded by run_key",
         cuts=cuts, train_images=len(resident), wall_s=wall, seconds_per_run=run_s,
         mean_seconds_per_run=statistics.mean(run_s), summary=summary,
         runs=[{k: r[k] for k in ("run_id", "iou", "acc", "final_loss")} for r in runs],
         keep_largest_removed_frac=removed, launches_main_path=launches,
         memory_after_grid=after_grid)
    return launches


def phase_compat():
    """The reference-named surface (compat/) at full width, the reference's
    flow step by step; each step's seconds. Then each compat output against
    the core function it wraps on the same tensors, and the card against
    the CPU."""
    import copy

    import torch

    from weaklysuperviseddl_tpu_torch.cam.cam import cam_bg
    from weaklysuperviseddl_tpu_torch.cam.layercam import layercam
    from weaklysuperviseddl_tpu_torch.compat import AlternatingDirectionCutLoss as CL
    from weaklysuperviseddl_tpu_torch.compat import PsuedoMasks, SegmentationModel
    from weaklysuperviseddl_tpu_torch.compat.ClassificationModel import (
        FrozenResNetCAM,
        evaluate_classification,
        train_fc_only,
    )
    from weaklysuperviseddl_tpu_torch.compat.LayerCAM import LayerCAMGenerator
    from weaklysuperviseddl_tpu_torch.compat.SegmentationDataset import PseudoSegmentationDataset
    from weaklysuperviseddl_tpu_torch.data.dataset import download_data
    from weaklysuperviseddl_tpu_torch.data.loader import batches
    from weaklysuperviseddl_tpu_torch.masks import densecrf
    from weaklysuperviseddl_tpu_torch.masks.components import keep_largest_batch
    from weaklysuperviseddl_tpu_torch.masks.pseudo import cam_to_mask
    from weaklysuperviseddl_tpu_torch.ops.bilateral import gaussian_filter_cuda
    from weaklysuperviseddl_tpu_torch.ops.cc import label_components_cuda
    from weaklysuperviseddl_tpu_torch.ops.refine import refine_cuda
    from weaklysuperviseddl_tpu_torch.train import classifier as core_classifier
    from weaklysuperviseddl_tpu_torch.train.refine import refine_from_soft_predictions

    quiet = lambda *_a, **_k: None  # noqa: E731
    root = CKPT_ROOT / "compat"
    root.mkdir(parents=True, exist_ok=True)
    train = download_data(None, split="trainval", synthetic_size=64, image_size=224, seed=0)
    fc_pets = download_data(None, split="trainval", synthetic_size=32, image_size=224, seed=1)
    steps, out = {}, {}

    @contextlib.contextmanager
    def step(name):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        steps[name] = time.perf_counter() - t0

    # ---- the main path: K1, K2 and K3 counts from 0, the flow, counts read after ----
    refine_cuda.launches = 0
    refine_cuda.plan_launches = dict.fromkeys(refine_cuda.plan_launches, 0)
    gaussian_filter_cuda.launches = 0
    reset_cc_counts()
    t_path = time.perf_counter()
    with step("FrozenResNetCAM"):
        model = FrozenResNetCAM(num_classes=37, depth=50, width_multiplier=1.0, seed=0,
                                device="cuda")
    with step("train_fc_only"):
        fc_before = model.fc.weight.detach().clone()
        train_fc_only(model, lambda: batches(fc_pets, 32, pad_to_full=True), device="cuda",
                      epochs=1, image_size=224, log=quiet)
        out["accuracy"] = evaluate_classification(model, lambda: batches(fc_pets, 32),
                                                  device="cuda", image_size=224, log=quiet)
    gen = LayerCAMGenerator(model, ["layer3", "layer4"])
    with step("generate_pseudo_masks"):
        img_dir, mask_dir = PsuedoMasks.generate_pseudo_masks(
            batches(train, 32, pad_to_full=True), gen, cam_thresh=0.3, alpha=1.0,
            keep_largest_masks=True, run_id="compat", root=str(root), log=quiet)
    image0, label0 = train.images[0], int(train.labels[0])
    with step("apply_dense_crf"):
        cam0 = gen.generate(image0, class_idx=[label0])[0]
        cam0_t = torch.where(cam0 < 0.3, torch.zeros_like(cam0), cam0)
        crf_mask = CL.apply_dense_crf(image0, cam0_t, **CRF_REFERENCE)
        crf_largest = PsuedoMasks.keep_largest(torch.from_numpy(crf_mask).cuda())
    with step("CAMGenerator.generate_bg_cam"):
        m_bg, max_obj = CL.CAMGenerator(model).generate_bg_cam(image0, [label0], alpha=2.0)
    with step("train_segmentation_model"):
        handle, seg_loss = SegmentationModel.train_segmentation_model(
            run_id="compat", lr=1e-4, num_epochs=1, batch_size=4, root=str(root),
            seg_size=256, log=quiet, device="cuda")
    ds = PseudoSegmentationDataset(img_dir, mask_dir, transform=True)
    seg_image, seg_mask = ds[0]
    refined = {}
    for lr in (1e-2, 0.2):
        with step(f"refine_pseudo_mask_lr{lr}"):
            refined[lr] = CL.refine_pseudo_mask(handle, seg_image, seg_mask, lr=lr)
    path_s = time.perf_counter() - t_path
    launches = {"refine": refine_cuda.launches, "cc_label": label_components_cuda.launches,
                "bilateral": gaussian_filter_cuda.launches}
    plans = dict(refine_cuda.plan_launches)
    check(all(v > 0 for v in launches.values()), f"compat path launches {launches}")
    check(launches["bilateral"] == 1 + CRF_REFERENCE["n_iters"],
          f"bilateral launched {launches['bilateral']} times, expected 6")
    check(launches["refine"] == 2 and plans["v1sym"] == 2,
          f"refine launched {launches['refine']} times by plan {plans}")
    check(launches["cc_label"] == 3, f"cc_label launched {launches['cc_label']} times, expected "
          "2 (64 pets in batches of 32) + 1 (keep_largest)")
    check_cc_image_plan("compat")

    # ---- each compat output against the core function it wraps ----
    t_checks = time.perf_counter()
    masks_png = SegmentationModel.read_pseudo_masks(str(root), "compat")
    names = sorted(os.listdir(mask_dir), key=lambda f: int(f.split(".")[0]))
    check(names == [f"{i}.png" for i in range(64)]
          and sorted(os.listdir(img_dir)) == sorted(names), f"pseudo-mask files {names[:3]}...")
    order = np.array([int(f.split(".")[0]) for f in sorted(os.listdir(mask_dir))])
    raw = torch.from_numpy(np.stack(train.images[:32])).cuda()
    labels = torch.from_numpy(train.labels[:32]).cuda()
    cams = layercam(model, raw.float(), labels.long(), target_layers=("layer3", "layer4"),
                    output_size=224)[0]
    compat_cams = gen.generate(raw, class_idx=labels)
    cam_err = float((cams - compat_cams).abs().max())
    check(cam_err < 1e-5, f"generate against layercam: {cam_err}")
    core_masks = cam_to_mask(cams, 0.3, True).cpu().numpy()
    first = order < 32
    mask_agree = float((masks_png[1][first] == core_masks[order[first]]).mean())
    check(mask_agree >= 0.9999, f"generate_pseudo_masks against cam_to_mask: {mask_agree}")
    core_crf = densecrf.apply_dense_crf(torch.from_numpy(image0).cuda()[None].float(),
                                        cam0_t[None], **CRF_REFERENCE)[0].cpu().numpy()
    check(np.array_equal(crf_mask, core_crf), "apply_dense_crf against densecrf.apply_dense_crf")
    check(np.array_equal(crf_largest, keep_largest_batch(torch.from_numpy(crf_mask).cuda()[None])
                         .cpu().numpy()[0]), "keep_largest against keep_largest_batch")
    valid = torch.zeros((1, 37), device="cuda")
    valid[0, label0] = 1.0
    core_bg = cam_bg(model, torch.from_numpy(image0).cuda()[None].float(), valid, alpha=2.0)
    bg_err = max(float((a[0] - b).abs().max()) for a, b in zip(core_bg, (m_bg, max_obj)))
    check(bg_err < 1e-6, f"generate_bg_cam against cam_bg: {bg_err}")
    check(np.isfinite(seg_loss) and not torch.equal(fc_before, model.fc.weight),
          f"seg loss {seg_loss}; the fc trained")
    x = torch.from_numpy(seg_image).cuda()[None]
    with torch.no_grad():
        handle.module.eval()
        logits = handle.module(x.permute(0, 3, 1, 2))
    check(torch.equal(handle(seg_image)["out"], logits), "SegModelHandle against the module")
    S = torch.softmax(logits.permute(0, 2, 3, 1), dim=-1).contiguous()
    m01 = torch.from_numpy((seg_mask == 255).astype(np.int32)).cuda()[None]
    for lr, got in refined.items():
        want, _ = refine_from_soft_predictions(S, x.contiguous(), m01, lr=lr)
        check(torch.equal(got, want[0].float()), f"refine_pseudo_mask lr {lr} against core")
    moved = {str(lr): float((r.cpu().numpy() != (seg_mask == 255)).mean())
             for lr, r in refined.items()}
    check(moved["0.01"] == 0.0, f"lr 1e-2 moved {moved['0.01']} of the pixels")
    acc_core = core_classifier.evaluate_classification(model, batches(fc_pets, 32),
                                                       image_size=224, log=quiet)
    check(acc_core == out["accuracy"], f"evaluate_classification {out['accuracy']} vs core "
          f"{acc_core}")
    t_checks = time.perf_counter() - t_checks

    # ---- the card against the CPU (each check's host seconds) ----
    cpu_s = {}
    t_cpu = time.perf_counter()
    cpu_model = copy.deepcopy(model).cpu()
    cpu_masks = cam_to_mask(LayerCAMGenerator(cpu_model, ["layer3", "layer4"]).generate(
        np.stack(train.images[:4]), class_idx=train.labels[:4]), 0.3, True).numpy()
    pick = [int(np.where(order == i)[0][0]) for i in range(4)]
    cpu_pseudo = float((masks_png[1][pick] == cpu_masks).mean())
    cpu_s["pseudo_masks"] = time.perf_counter() - t_cpu
    # the reference CRF on a 112² crop of the image, the one of 9 (offsets 0,
    # 56, 112 a side) whose card mask is nearest half foreground: the exact
    # filter on the host costs about 16 times less than at 224²
    t_cpu = time.perf_counter()
    crop_at = min(((y, x) for y in (0, 56, 112) for x in (0, 56, 112)),
                  key=lambda o: abs(crf_mask[o[0]:o[0] + 112, o[1]:o[1] + 112].mean() - 0.5))
    crop = (slice(crop_at[0], crop_at[0] + 112), slice(crop_at[1], crop_at[1] + 112))
    crop_image, crop_cam = np.ascontiguousarray(image0[crop]), cam0_t[crop].contiguous()
    card_crf = CL.apply_dense_crf(crop_image, crop_cam, **CRF_REFERENCE)
    cpu_crf = CL.apply_dense_crf(crop_image, crop_cam.cpu(), **CRF_REFERENCE)
    cpu_crf_agree = float((cpu_crf == card_crf).mean())
    cpu_s["crf_112"] = time.perf_counter() - t_cpu
    t_cpu = time.perf_counter()
    cpu_handle = SegmentationModel.SegModelHandle(copy.deepcopy(handle.module).cpu(),
                                                  handle.state, 256)
    cpu_refined = CL.refine_pseudo_mask(cpu_handle, seg_image, seg_mask, lr=0.2)
    cpu_refine = float((cpu_refined == refined[0.2].cpu()).float().mean())
    cpu_s["refine"] = time.perf_counter() - t_cpu
    check(cpu_pseudo >= 0.995, f"pseudo-masks card vs CPU {cpu_pseudo}")
    check(cpu_crf_agree >= 0.999, f"CRF mask card vs CPU {cpu_crf_agree}")
    check(cpu_refine >= 0.995, f"refined mask card vs CPU {cpu_refine}")
    shutil.rmtree(root, ignore_errors=True)
    emit("compat", entry="weaklysuperviseddl_tpu_torch.compat (the reference's names)",
         models="FrozenResNetCAM ResNet-50 dilated (37 classes, 224², seed 0); DeepLabV3-ResNet50 "
                "os8 (256², batch 4, seed 0)",
         cuts={"train_fc_only": "1 epoch on 32 synthetic pets (batch 32)",
               "generate_pseudo_masks": "64 synthetic pets (batch 32)",
               "train_segmentation_model": "1 epoch on those 64 pseudo-masks"},
         crf_kwargs=CRF_REFERENCE, seconds_by_step=steps, path_s=path_s,
         checks_s=t_checks, cpu_checks_s=cpu_s,
         fusion="auto (K5 off this path, as in the JAX package)",
         accuracy_macro_f1=out["accuracy"], seg_final_loss=seg_loss,
         generate_vs_layercam_max_abs=cam_err, pseudo_masks_vs_cam_to_mask=mask_agree,
         bg_cam_vs_cam_bg_max_abs=bg_err, refine_moved_frac=moved,
         card_vs_cpu={"pseudo_masks_4_pets": cpu_pseudo, "crf_mask_112_crop": cpu_crf_agree,
                      "crf_crop_at": list(crop_at), "crf_crop_fg": float(card_crf.mean()),
                      "refined_mask_lr0.2": cpu_refine},
         launches_main_path=launches, refine_plans=plans)
    return launches


# kinds of kernel in a BASNet forward, by a key in the profiler's name, the
# first kind that matches (cuDNN's BatchNorm kernels carry "cudnn" too)
BASNET_KINDS = (("batch_norm", ("batch_norm", "bn_fw", "bn_bw")),
                ("upsample", ("upsample",)), ("max_pool", ("max_pool",)),
                ("cat", ("CatArray", "cat_")),
                ("conv", ("conv", "implicit", "gemm", "xmma", "cudnn", "cutlass", "winograd",
                          "fft", "complex", "sm90", "sm80", "dgrad", "wgrad")))


def basnet_breakdown(model, x) -> dict:
    """Device ms of one BASNet forward by kind of kernel (torch.profiler),
    and the longest kernels by the names the profiler prints."""
    import torch

    with torch.inference_mode():
        total, names = device_ms(lambda: model(x), runs=3, warmup=1)

    def kind(name):
        low = name.lower()
        for k, keys in BASNET_KINDS:
            if any(key.lower() in low for key in keys):
                return k
        return "elementwise_and_other"

    kinds = {k: 0.0 for k, _ in BASNET_KINDS} | {"elementwise_and_other": 0.0}
    for name, ms in names.items():
        kinds[kind(name)] += ms
    return {"total_ms": total, "by_kind_ms": kinds,
            "top": sorted(((short_name(k)[:120], v) for k, v in names.items()),
                          key=lambda kv: -kv[1])[:10]}


def phase_basnet():
    """BASNet saliency (pipelines/basnet_infer.py, train/basnet.py, the CLI's
    ``basnet``) at 256², random weights from seed 0. No hand kernel: cuDNN
    convolutions and plain PyTorch around them."""
    import contextlib
    import copy
    import io
    import os

    import torch

    from weaklysuperviseddl_tpu_torch import cli
    from weaklysuperviseddl_tpu_torch.data.dataset import download_data
    from weaklysuperviseddl_tpu_torch.data.preprocess import normalize_images, preprocess_batch
    from weaklysuperviseddl_tpu_torch.pipelines import basnet_demo
    from weaklysuperviseddl_tpu_torch.pipelines.basnet_infer import (
        IMG_SIZE,
        build_basnet,
        norm_pred,
        run_inference,
        saliency_dout,
        saliency_step,
    )
    from weaklysuperviseddl_tpu_torch.train.basnet import train_basnet

    t_phase = time.perf_counter()
    model = build_basnet(device="cuda", generator=torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == 87_060_360, f"BASNet has {n_params} parameters")
    cpu_model = copy.deepcopy(model).cpu()

    # the card against the CPU, same weights, 8 synthetic test pets at 256²
    pets8 = pets("test", 8, IMG_SIZE, seed=0)
    card = saliency_dout(model, torch.from_numpy(pets8).cuda()).cpu()
    cpu = saliency_dout(cpu_model, torch.from_numpy(pets8))
    del cpu_model
    dout_err = float((card - cpu).abs().max())
    masks_agree = float(((norm_pred(card) > 0.5) == (norm_pred(cpu) > 0.5)).float().mean())
    check(card.shape == (8, IMG_SIZE, IMG_SIZE) and bool(torch.isfinite(card).all()),
          f"dout {tuple(card.shape)} not finite [8,256,256]")
    check(dout_err <= 1e-4, f"BASNet dout card/CPU max abs err {dout_err} > 1e-4")
    check(masks_agree >= 0.999, f"BASNet card/CPU mask agreement {masks_agree} < 0.999")

    # the reference's protocol: run_inference on 10 test pets, no PNGs
    test_ds = download_data(None, split="test", synthetic_size=10)
    t0 = time.perf_counter()
    results, mean_iou, mean_acc = run_inference(test_ds, model=model, num_images=10,
                                                output_folder=None, log=lambda *_: None)
    protocol_s = time.perf_counter() - t0
    check(len(results) == 10 and all(0.0 <= v <= 1.0 for r in results for v in r),
          f"protocol results {results}")
    # the same through the CLI a user calls, on the card by default, in a
    # scratch directory (PNGs where PIL is installed)
    cli_dir = CKPT_ROOT / "basnet_cli"
    cli_dir.mkdir(parents=True, exist_ok=True)
    out, cwd = io.StringIO(), os.getcwd()
    os.chdir(cli_dir)
    try:
        with contextlib.redirect_stdout(out):
            rc = cli.main(["basnet", "--num-images", "10"])
    finally:
        os.chdir(cwd)
    cli_lines = out.getvalue().splitlines()
    check(rc == 0 and cli_lines[-1].startswith("Mean IoU: "), f"basnet CLI: {cli_lines[-3:]}")
    cli_iou = float(cli_lines[-1].split("Mean IoU: ")[1].split(",")[0])
    check(abs(cli_iou - mean_iou) <= 1e-3,
          f"basnet CLI mean IoU {cli_iou} against run_inference's {mean_iou}")

    # batched saliency_step throughput at batch 16, 20 calls with the uint8
    # upload and the maps' readback (the JAX package's run_aux_scale window)
    pets64 = pets("test", 64, IMG_SIZE, seed=0)
    batch16 = pets64[:16]
    saliency_step(model, torch.from_numpy(batch16).cuda()).cpu()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        saliency_step(model, torch.from_numpy(batch16).cuda()).cpu()
    throughput = 16 * 20 / (time.perf_counter() - t0)

    # the model's ms an image by batch: three medians of CUDA events each
    x, _ = preprocess_batch(torch.from_numpy(pets64[:32]).cuda(), None, size=IMG_SIZE)
    x = normalize_images(x).permute(0, 3, 1, 2).contiguous()
    by_batch = {}
    with torch.inference_mode():
        for b in (1, 8, 16, 32):
            model(x[:b])
            by_batch[b] = spread([cuda_ms(lambda: model(x[:b]), runs=5, warmup=1) / b
                                  for _ in range(3)])
    breakdown = basnet_breakdown(model, x[:16])

    # a cut of the demo's recipe: trainval pets at 256², batch 8, 3e-4, clip 1,
    # cosine to 1e-5; held-out IoU through the engine before and after
    n_train, n_held, epochs, bs = 64, 32, 30, 8
    train_ds = download_data(None, split="trainval", synthetic_size=n_train,
                             image_size=IMG_SIZE, seed=0)
    held_ds = download_data(None, split="test", synthetic_size=n_held, image_size=IMG_SIZE,
                            seed=0)
    del model
    trained = build_basnet(device="cuda", generator=torch.Generator().manual_seed(0))
    _, iou0, _ = run_inference(held_ds, model=trained, num_images=n_held, output_folder=None,
                               log=lambda *_: None)
    images, targets = basnet_demo.training_arrays(train_ds, n_train, bs, IMG_SIZE, "cuda")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, history = train_basnet(trained, images, targets, epochs=epochs, batch_size=bs, lr=3e-4,
                              clip_norm=1.0, lr_end=1e-5, log=lambda *_: None)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    _, iou1, acc1 = run_inference(held_ds, model=trained, num_images=n_held,
                                  output_folder=None, log=lambda *_: None)
    check(all(np.isfinite(history)), f"BASNet training losses {history}")
    check(history[-1] < history[0], f"BASNet loss did not fall: {history[0]} -> {history[-1]}")
    check(iou1 > iou0, f"BASNet held-out IoU {iou1} not above random init's {iou0}")
    steps = epochs * n_train // bs
    emit("basnet", entry="pipelines.basnet_infer (build_basnet, saliency_step, run_inference), "
         "train.basnet.train_basnet, cli basnet",
         model="BASNet(3, 1) at 256², 87.06 M parameters, random init (seed 0)",
         params=n_params, card_cpu={"images": 8, "dout_max_abs_err": dout_err,
                                    "mask_agreement": masks_agree},
         protocol={"images": 10, "mean_iou": mean_iou, "mean_acc": mean_acc,
                   "seconds": protocol_s, "cli_mean_iou": cli_iou,
                   "cli_pngs": (cli_dir / "basnet_outputs").is_dir()},
         saliency_img_per_s_batch16=throughput,
         model_ms_per_image_by_batch=by_batch, device_ms_batch16=breakdown,
         training={"cut": {"train_images": n_train, "held_out_images": n_held,
                           "epochs": epochs, "of_demo": "200 images, 50 held out, 120 epochs"},
                   "batch_size": bs, "steps": steps, "seconds": train_s,
                   "img_per_s": steps * bs / train_s, "ms_per_step": train_s / steps * 1e3,
                   "peak_mem_gb": peak_gb, "loss_first_epoch": history[0],
                   "loss_last_epoch": history[-1], "held_out_iou_random_init": iou0,
                   "held_out_iou_trained": iou1, "held_out_acc_trained": acc1},
         wall_s=time.perf_counter() - t_phase)


def conv_profile(model, x, batches=(16, 32)) -> dict:
    """DeepLabV3's float32 forward, layer by layer, at each of ``batches``:
    every convolution of layer3, layer4 and the head (the 32² maps, where
    the dilated convolutions are) replayed alone on the input it gets in the
    forward, with the kernels the profiler names and their device ms an
    image; the
    convolutions whose kernels change between the batches, or whose ms an
    image grows by more than half; and the whole forward's ms an image at
    batches 16, 32 and 64 as it runs, with cudnn.benchmark, and in
    channels_last (each a median of CUDA events; every setting restored)."""
    import copy

    import torch
    import torch.nn.functional as F

    from weaklysuperviseddl_tpu_torch.models.deeplabv3 import AtrousConv

    out = {"by_conv": {}}
    for b in batches:
        inputs = {}
        hooks = [m.register_forward_pre_hook(
            lambda mod, args, name=name: inputs.setdefault(name, args[0]))
            for name, m in model.named_modules() if isinstance(m, torch.nn.Conv2d)
            and name.startswith(("backbone.layer3", "backbone.layer4", "classifier"))]
        try:
            with torch.inference_mode():
                model(x[:b])
        finally:
            for h in hooks:
                h.remove()
        with torch.inference_mode():
            for name, inp in inputs.items():
                m = model.get_submodule(name)
                row = out["by_conv"].setdefault(name, {"input": list(inp.shape[1:]),
                                                       "kernel": list(m.weight.shape[2:]),
                                                       "dilation": list(m.dilation)})
                row[str(b)] = top_kernels(lambda: m(inp), b)
                if isinstance(m, AtrousConv):
                    # the dilated convolution this branch ran before the tap plan
                    row[f"{b}_dilated_conv"] = top_kernels(lambda: F.conv2d(
                        inp, m.weight, None, 1, m.rate, m.rate), b)
        del inputs
    lo, hi = (str(b) for b in batches)
    out["changed"] = [
        name for name, row in out["by_conv"].items()
        if [k for k, _ in row[lo]["kernels"]] != [k for k, _ in row[hi]["kernels"]]
        or (row[lo]["ms_per_image"] and row[hi]["ms_per_image"]
            and row[hi]["ms_per_image"] > 1.5 * row[lo]["ms_per_image"])]
    whole = {}
    bench = torch.backends.cudnn.benchmark
    try:
        for setting in ("default", "cudnn_benchmark", "channels_last"):
            torch.backends.cudnn.benchmark = setting == "cudnn_benchmark"
            m, xs = model, x
            if setting == "channels_last":
                m = copy.deepcopy(model).to(memory_format=torch.channels_last)
                xs = x.contiguous(memory_format=torch.channels_last)
            with torch.inference_mode():
                whole[setting] = {str(b): cuda_ms(lambda: m(xs[:b]), runs=3, warmup=1) / b
                                  for b in (16, 32, 64)}
            del m
    finally:
        torch.backends.cudnn.benchmark = bench
    out["forward_ms_per_image"] = whole
    return out


def top_kernels(fn, per: int = 1, top: int = 4) -> dict:
    """Device ms of ``fn`` per ``per`` (an image, say) from a profiler trace,
    and its ``top`` kernels by device time, [short name, ms per ``per``]."""
    total, names = device_ms(fn, runs=2, warmup=1, traces=3)
    ranked = sorted(names.items(), key=lambda kv: -kv[1])[:top]
    return {"ms_per_image": None if total is None else total / per,
            "kernels": [[short_name(k)[:90], v / per] for k, v in ranked]}


def seg_step_ms(model, images, masks, dtype_note: str) -> dict:
    """One segmentation training step at batch 4 (seg_train_step, Adam behind
    the guard): ms (median of CUDA events) and peak GB."""
    import torch

    from weaklysuperviseddl_tpu_torch.train.guard import GuardedAdam
    from weaklysuperviseddl_tpu_torch.train.segmentation import (
        SegTrainState,
        _prep,
        seg_train_step,
    )

    state = SegTrainState(model, GuardedAdam(model.parameters(), lr=1e-4))
    x, mm = _prep(torch.from_numpy(images).cuda(), torch.from_numpy(masks).cuda(), 256)
    valid = torch.ones(4, dtype=torch.bool, device="cuda")
    seg_train_step(state, x, mm, valid)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: seg_train_step(state, x, mm, valid), runs=5, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    trace = top_kernels(lambda: seg_train_step(state, x, mm, valid), top=8)
    return {"ms": ms, "img_per_s": 4e3 / ms, "peak_gb": peak, "compute": dtype_note,
            "device_ms": trace["ms_per_image"], "top_kernels": trace["kernels"]}


def tf32_on():
    """A context with TF32 on for cuDNN convolutions and matmuls, restored
    to the script's setting (off) when it ends."""
    import contextlib

    import torch

    @contextlib.contextmanager
    def ctx():
        old = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old

    return ctx()


def k5_half(dtype: str) -> dict:
    """K5 on 16-bit act and grad: the full-width classifier in ``dtype``
    (seed 0), its layer3 and layer4 on 32 synthetic pets at 224², each
    bit-equal to K5 on the float32 upcasts, within 1e-6 of plain, two launches
    identical, timed beside its bound (bytes of 16-bit inputs) and beside the
    float32 launch; then the path, layercam(fusion="pallas") on that
    classifier, with the counts by input type reset just before and read just
    after (2 launches of ``dtype``)."""
    import torch

    from weaklysuperviseddl_tpu_torch.cam.layercam import layercam
    from weaklysuperviseddl_tpu_torch.data.preprocess import preprocess_batch
    from weaklysuperviseddl_tpu_torch.data.synthetic import synthetic_pet_arrays
    from weaklysuperviseddl_tpu_torch.models.classifier import CamClassifier
    from weaklysuperviseddl_tpu_torch.models.resnet import compute_dtype, init_weights
    from weaklysuperviseddl_tpu_torch.ops.cam_fusion import (
        cam_fusion_cuda,
        cam_fusion_plain,
        cluster_size,
        max_active_clusters,
        sm_count,
    )

    dt = compute_dtype(dtype)
    model = CamClassifier(37, 50, 1.0, dtype=dtype)
    init_weights(model, torch.Generator().manual_seed(0))
    model = model.cuda().eval()
    images, labels, _ = synthetic_pet_arrays(32, image_size=224, seed=8)
    x, _ = preprocess_batch(torch.from_numpy((images * 255).astype(np.uint8)).cuda(), None,
                            size=224)
    cls = torch.from_numpy(labels).cuda()
    xi = x.permute(0, 3, 1, 2).detach().requires_grad_(True)
    logits, feats = model.features(xi)
    acts = [feats["layer3"], feats["layer4"]]
    grads = torch.autograd.grad(logits.gather(1, cls.long().view(-1, 1)).sum(), acts)
    check(all(t.dtype == dt for t in (*acts, *grads)),
          f"the {dtype} classifier's activations or gradients are not {dtype}")
    check(all(bool(torch.isfinite(t).all()) for t in (*acts, *grads)),
          f"the {dtype} classifier's activations or gradients are not finite")
    k5, max_err = {}, 0.0
    for name, a, g in (("layer3", acts[0], grads[0]), ("layer4", acts[1], grads[1])):
        a, g = a.detach().contiguous(), g.contiguous()
        af, gf = a.float(), g.float()
        got = cam_fusion_cuda(a, g)
        again = cam_fusion_cuda(a, g)
        upcast = cam_fusion_cuda(af, gf)
        want = cam_fusion_plain(a, g)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(torch.equal(got, upcast), f"K5 on {dtype} {name} differs from K5 on its upcasts")
        check(torch.equal(again, got), f"K5 on {dtype} differs between launches at {name}")
        check(err <= 1e-6, f"K5 on {dtype} {name} differs from plain by {err}")
        max_err = max(max_err, err)
        B, C, h, w = a.shape
        S = cluster_size(B, C, sm_count(a.device))
        # bytes: 16-bit act and grad read once, the float32 CAM written once
        bound_ms, bound_by = roofline(B * h * w * (2 * 2 * C + 4), 3 * B * C * h * w)
        k5[name] = {"shape": list(a.shape), "cluster_size": S,
                    "max_active_clusters": max_active_clusters(C, h * w, S, (h * w) % 4 == 0,
                                                               dt),
                    "max_abs_err": err, "bit_equal_to_float32_upcast": True,
                    **kernel_ms(lambda: cam_fusion_cuda(a, g), runs=50, warmup=5),
                    "host_ms": host_ms(lambda: cam_fusion_cuda(a, g), runs=50),
                    "plain_ms": cuda_ms(lambda: cam_fusion_plain(a, g), runs=50, warmup=5),
                    "float32_kernel_ms": cuda_ms(lambda: cam_fusion_cuda(af, gf), runs=50,
                                                 warmup=5),
                    "bound_ms": bound_ms, "bound_by": bound_by}
    del acts, grads, feats, logits
    # the main path: counts from 0, layercam(fusion="pallas") on the 16-bit
    # classifier, read after
    cam_fusion_cuda.launches = 0
    cam_fusion_cuda.launches_by_dtype = dict.fromkeys(cam_fusion_cuda.launches_by_dtype, 0)
    cam_k, _ = layercam(model, x, cls, output_size=224, fusion="pallas")
    torch.cuda.synchronize()
    launches = dict(cam_fusion_cuda.launches_by_dtype)
    want_launches = {**dict.fromkeys(launches, 0), dtype: 2}
    check(launches == want_launches, f"layercam(fusion='pallas') in {dtype} launched {launches}")
    cam_p, _ = layercam(model, x, cls, output_size=224, fusion="xla")
    layercam_err = float((cam_k - cam_p).abs().max())
    check(layercam_err <= 1e-5, f"{dtype} layercam pallas vs xla: {layercam_err}")
    check(cam_k.dtype == torch.float32 and tuple(cam_k.shape) == (32, 224, 224)
          and bool(torch.isfinite(cam_k).all()), f"{dtype} CAMs are not finite float32")
    return {"k5": k5, "max_abs_err": max_err, "launches": launches,
            "layercam_pallas_vs_xla": layercam_err}


def cut_cycle(dtype: str, fp32_masks) -> dict:
    """The weakly phase's cut full-width cycle with classifier.dtype =
    seg.dtype = ``dtype`` (K1 and K2 counted from 0); its final store masks
    against the float32 run's ``fp32_masks`` (agreement reported: the two
    runs train apart by rounding); its trained models against float32 builds
    of the same weights: pseudo-masks of 32 pets and DeepLabV3's argmax on 8
    store images (each >= 0.99)."""
    import math

    import torch

    from weaklysuperviseddl_tpu_torch.cam.layercam import layercam
    from weaklysuperviseddl_tpu_torch.config import (
        AlternatingConfig,
        ClassifierConfig,
        ExperimentConfig,
        SegConfig,
    )
    from weaklysuperviseddl_tpu_torch.data.preprocess import preprocess_batch
    from weaklysuperviseddl_tpu_torch.masks.pseudo import cam_to_mask
    from weaklysuperviseddl_tpu_torch.models.classifier import CamClassifier
    from weaklysuperviseddl_tpu_torch.models.deeplabv3 import DeepLabV3
    from weaklysuperviseddl_tpu_torch.models.resnet import compute_dtype
    from weaklysuperviseddl_tpu_torch.ops.cc import label_components_cuda
    from weaklysuperviseddl_tpu_torch.ops.refine import refine_cuda
    from weaklysuperviseddl_tpu_torch.pipelines.weakly import run_weakly_supervised_alternating
    from weaklysuperviseddl_tpu_torch.train.segmentation import _normalize_images
    from weaklysuperviseddl_tpu_torch.utils.profiling import Stopwatch

    cuts = {"classifier.epochs": 2, "seg.epochs": 1, "alternating.num_alternations": 2,
            "alternating.epochs_per_round": 1, "alternating.refine_repeats": 2}
    cfg = ExperimentConfig(
        classifier=ClassifierConfig(epochs=2, dtype=dtype),
        seg=SegConfig(epochs=1, dtype=dtype),
        alternating=AlternatingConfig(num_alternations=2, epochs_per_round=1, refine_repeats=2))
    sw = Stopwatch("cuda")
    reset_cc_counts()
    refine_cuda.launches = 0
    refine_cuda.plan_launches = dict.fromkeys(refine_cuda.plan_launches, 0)
    t0 = time.perf_counter()
    result = run_weakly_supervised_alternating(cfg, stopwatch=sw, log=lambda *_: None,
                                               device="cuda")
    wall = time.perf_counter() - t0
    launches = {"refine": refine_cuda.launches, "cc_label": label_components_cuda.launches}
    n_train = len(result.mask_store)
    want_refine = math.ceil(n_train / cfg.seg.batch_size) * 2 * 2
    check(launches["refine"] == want_refine and refine_cuda.plan_launches["v1sym"] == want_refine,
          f"{dtype} cycle launched refine {launches['refine']} times "
          f"({refine_cuda.plan_launches}), expected {want_refine} v1sym")
    check(launches["cc_label"] > 0, f"the {dtype} cycle never launched the cc kernel")
    check_cc_image_plan(dtype)
    m = result.metrics
    scalars = {k: m[k] for k in ("iou", "acc", "final_loss", "alt_iou", "alt_acc")}
    check(all(math.isfinite(v) for v in scalars.values()), f"non-finite {dtype} metrics {scalars}")
    store_images, store_masks, _ = result.mask_store.as_arrays()
    check(store_masks.shape == (n_train, 256, 256) and set(np.unique(store_masks)) <= {0, 1},
          f"{dtype} store masks are not binary [N,256,256]")
    classifier, seg = result.classifier, result.seg_state.model
    check(classifier.compute_dtype == seg.compute_dtype == compute_dtype(dtype)
          and all(p.dtype == torch.float32 for p in seg.parameters()),
          f"the {dtype} cycle's models are not {dtype} over float32 parameters")
    opt = result.seg_state.optimizer

    # the same weights in float32 builds: pseudo-masks of 32 train images and
    # DeepLabV3's argmax on 8 store images
    fp32_cls = CamClassifier(37, 50, 1.0).cuda().eval()
    fp32_cls.load_state_dict(classifier.state_dict())
    fp32_seg = DeepLabV3(2, 50, 1.0).cuda().eval()
    fp32_seg.load_state_dict(seg.state_dict())
    train_pets = pets("trainval", 32, 224, seed=0)
    xc, _ = preprocess_batch(torch.from_numpy(train_pets).cuda(), None, size=224)
    cls32 = torch.arange(32, device="cuda") % 37
    masks_by = {}
    for key, mdl in (("half", classifier), ("fp32", fp32_cls)):
        cam, _ = layercam(mdl, xc, cls32, output_size=224)
        masks_by[key] = cam_to_mask(cam, cfg.mask.cam_thresh, True)
    mask_agree = float((masks_by["half"] == masks_by["fp32"]).float().mean())
    xs, _ = preprocess_batch(torch.from_numpy(store_images[:8]).cuda(), None, size=256)
    xs = _normalize_images(xs).permute(0, 3, 1, 2)
    seg.eval()
    with torch.no_grad():
        argmax_agree = float((seg(xs).argmax(1) == fp32_seg(xs).argmax(1)).float().mean())
    check(mask_agree >= 0.99, f"{dtype}/fp32 pseudo-mask agreement {mask_agree} < 0.99")
    check(argmax_agree >= 0.99, f"{dtype}/fp32 seg argmax agreement {argmax_agree} < 0.99")
    check(fp32_masks.shape == store_masks.shape, "the float32 run's store has another shape")
    phases = {name: {"seconds": sw.times[name], "img_per_s": sw.rate(name)} for name in sw.times}
    return {"line": {"cuts": cuts, "train_images": n_train, "wall_s": wall, "phases": phases,
                     "metrics": m, "launches_main_path": launches,
                     "skipped_steps": int(opt.total_notfinite),
                     "final_masks_agreement_with_float32_run": float(
                         (store_masks == fp32_masks).mean()),
                     "same_weights_as_float32": {"pseudo_mask_agreement": mask_agree,
                                                 "seg_argmax_agreement": argmax_agree}},
            "launches": launches, "seg": seg, "store_images": store_images,
            "store_masks": store_masks}


def phase_bf16(fp32_masks):
    """The 16-bit compute dtypes (classifier.dtype, seg.dtype, BASNet's
    dtype): K5 on bfloat16 and on float16 inputs, the cut full-width cycle in
    each against the float32 run, the segmentation step eager and graphed in
    float16, and the segmentation step and BASNet in float32, TF32 and
    bfloat16."""
    import copy

    import torch

    from weaklysuperviseddl_tpu_torch.data.dataset import download_data
    from weaklysuperviseddl_tpu_torch.data.preprocess import normalize_images, preprocess_batch
    from weaklysuperviseddl_tpu_torch.models.deeplabv3 import DeepLabV3
    from weaklysuperviseddl_tpu_torch.pipelines import basnet_demo
    from weaklysuperviseddl_tpu_torch.pipelines.basnet_infer import (
        IMG_SIZE,
        build_basnet,
        saliency_step,
    )
    from weaklysuperviseddl_tpu_torch.train.basnet import Adam, make_basnet_train_step
    from weaklysuperviseddl_tpu_torch.train.guard import GuardedAdam
    from weaklysuperviseddl_tpu_torch.train.segmentation import SegTrainState

    t_phase = time.perf_counter()
    half = {dtype: k5_half(dtype) for dtype in ("bfloat16", "float16")}
    cycles = {dtype: cut_cycle(dtype, fp32_masks) for dtype in ("bfloat16", "float16")}
    cycles_lines = {dtype: {"line": c["line"], "launches": c["launches"]}
                    for dtype, c in cycles.items()}
    bf16 = cycles["bfloat16"]
    seg, store_images, store_masks = bf16["seg"], bf16["store_images"], bf16["store_masks"]

    # ---- the float16 leg: the training step at batch 4, eager and graphed
    # (chunks of 8), from the float16 cycle's weights ----
    fp16 = cycles["float16"]
    model16 = DeepLabV3(2, 50, 1.0, dtype="float16").cuda()
    model16.load_state_dict(fp16["seg"].state_dict())
    step_fp16 = step_dispatch_times(
        SegTrainState(model16, GuardedAdam(model16.parameters(), lr=1e-4)),
        torch.from_numpy(fp16["store_images"][:32]).cuda(),
        torch.from_numpy(fp16["store_masks"][:32]).cuda(), 8, 4)
    del model16, fp16, cycles["float16"]
    torch.cuda.empty_cache()

    # ---- the segmentation step at batch 4: float32, TF32 and bfloat16, one
    # set of weights (the cycle's) ----
    step = {}
    for key, dtype in (("fp32", "float32"), ("tf32", "float32"), ("bf16", "bfloat16"),
                       ("bf16_channels_last", "bfloat16")):
        mdl = DeepLabV3(2, 50, 1.0, dtype=dtype).cuda()
        mdl.load_state_dict(seg.state_dict())
        if key == "bf16_channels_last":  # a measurement only: the path keeps torch's default
            mdl = mdl.to(memory_format=torch.channels_last)
        if key == "tf32":
            with tf32_on():
                step[key] = seg_step_ms(mdl, store_images[:4], store_masks[:4], "TF32")
        else:
            step[key] = seg_step_ms(mdl, store_images[:4], store_masks[:4], dtype)
        del mdl
    del cycles, bf16, seg

    # ---- BASNet: a forward at batch 16 and a train step at batch 8 in
    # float32, TF32 and bfloat16 (seed 0 weights), and the bfloat16
    # saliency masks against float32's ----
    bas = {"fp32": build_basnet(device="cuda", generator=torch.Generator().manual_seed(0))}
    bas["bf16"] = build_basnet(device="cuda", generator=torch.Generator().manual_seed(0),
                               dtype="bfloat16")
    pets16 = pets("test", 16, IMG_SIZE, seed=0)
    sal = {k: saliency_step(bas[k], torch.from_numpy(pets16).cuda()) for k in bas}
    sal_agree = float(((sal["bf16"] > 0.5) == (sal["fp32"] > 0.5)).float().mean())
    check(sal["bf16"].dtype == torch.float32, "bfloat16 saliency maps are not float32")
    check(sal_agree >= 0.99, f"BASNet bf16/fp32 saliency mask agreement {sal_agree} < 0.99")
    xb, _ = preprocess_batch(torch.from_numpy(pets16).cuda(), None, size=IMG_SIZE)
    xb = normalize_images(xb).permute(0, 3, 1, 2).contiguous()
    train_ds = download_data(None, split="trainval", synthetic_size=8, image_size=IMG_SIZE,
                             seed=0)
    ti, tt = basnet_demo.training_arrays(train_ds, 8, 8, IMG_SIZE, "cuda")
    ti = ti.permute(0, 3, 1, 2).contiguous()
    basnet_rows = {}
    for key in ("fp32", "tf32", "bf16"):
        mdl = bas["bf16" if key == "bf16" else "fp32"]
        mdl.eval()
        with tf32_on() if key == "tf32" else contextlib.nullcontext():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with torch.inference_mode():
                fwd = cuda_ms(lambda: mdl(xb), runs=5, warmup=2)
            fwd_gb = torch.cuda.max_memory_allocated() / 2**30
            trainee = copy.deepcopy(mdl)
            step_fn = make_basnet_train_step(trainee, Adam(trainee.parameters(), lr=3e-4),
                                             clip_norm=1.0)
            step_fn(ti, tt)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            train = cuda_ms(lambda: step_fn(ti, tt), runs=5, warmup=1)
            train_gb = torch.cuda.max_memory_allocated() / 2**30
            del trainee, step_fn
        basnet_rows[key] = {"forward_b16_ms": fwd, "forward_img_per_s": 16e3 / fwd,
                            "forward_peak_gb": fwd_gb, "train_step_b8_ms": train,
                            "train_img_per_s": 8e3 / train, "train_peak_gb": train_gb}
    del bas
    emit("bf16", entry="run_weakly_supervised_alternating (classifier.dtype = seg.dtype = "
         "bfloat16, then float16); cam/layercam fusion='pallas'; "
         "pipelines.basnet_infer.build_basnet(dtype=)",
         k5={dtype: h["k5"] for dtype, h in half.items()},
         k5_launches_main_path={dtype: h["launches"] for dtype, h in half.items()},
         layercam_pallas_vs_xla={dtype: h["layercam_pallas_vs_xla"] for dtype, h in half.items()},
         cycle={dtype: c["line"] for dtype, c in cycles_lines.items()},
         seg_step_batch4=step, float16_step_batch4_k8=step_fp16, basnet=basnet_rows,
         basnet_saliency_bf16_fp32_agreement=sal_agree, wall_s=time.perf_counter() - t_phase)
    return {dtype: {"launches": h["launches"][dtype], "max_abs_err": h["max_abs_err"],
                    **h["k5"]["layer4"], "cycle_launches": cycles_lines[dtype]["launches"]}
            for dtype, h in half.items()}


def crf_batch_inputs(resident, image_size: int, cam_thresh: float):
    """The CRF's (probs [B,S,S,2], images [B,S,S,3] in [0,255]) of the
    extraction's batch, as _derive_batch hands them to the CRF."""
    import torch

    from weaklysuperviseddl_tpu_torch.data.preprocess import preprocess_batch

    x, _ = preprocess_batch(resident.images_raw, None, size=image_size)
    cam = torch.where(resident.cams < cam_thresh, torch.zeros_like(resident.cams),
                      resident.cams)
    return torch.stack([1.0 - cam, cam], dim=-1).clamp(1e-8, 1.0), x * 255.0


def lattice_vs_exact(probs, images, sxy: float, srgb: float) -> dict:
    """The lattice on the CRF's batch: the ms of its precompute and of one
    filter call of the initial Q over the whole batch; on image 0 its
    vertices against its M entries, and its raw filter against K3's exact
    filter, each normalised by its own filter of ones (the two carry
    different constant scales)."""
    import torch

    from weaklysuperviseddl_tpu_torch.masks.densecrf import _bilateral_features
    from weaklysuperviseddl_tpu_torch.masks.permutohedral import (
        permutohedral_filter,
        permutohedral_precompute,
    )
    from weaklysuperviseddl_tpu_torch.ops.bilateral import gaussian_filter_cuda

    B = probs.shape[0]
    feats = _bilateral_features(images, sxy, srgb).reshape(B, -1, 5).contiguous()
    v = probs.reshape(B, -1, 2).contiguous()
    pre = permutohedral_precompute(feats)
    timing = {"batch": B,
              "precompute_ms": cuda_ms(lambda: permutohedral_precompute(feats), runs=3, warmup=1),
              "filter_ms": cuda_ms(lambda: permutohedral_filter(v, pre), runs=5, warmup=1)}
    f0, v0 = feats[:1], v[:1]
    ones = torch.ones((1, v0.shape[1], 1), device=v.device)
    pre0 = permutohedral_precompute(f0)
    lat = permutohedral_filter(v0, pre0) / permutohedral_filter(ones, pre0)
    ex = gaussian_filter_cuda(f0, f0, v0) / gaussian_filter_cuda(f0, f0, ones)
    diff = (lat - ex).abs()
    return {"vertices_image0": int(pre["n_vertices"][0]), "M": pre["M"], **timing,
            "filter_rel_max_image0": float(diff.max() / ex.abs().max()),
            "filter_rel_mean_image0": float(diff.mean() / ex.abs().mean())}


def phase_crf_backends():
    import torch

    from weaklysuperviseddl_tpu_torch.config import ExperimentConfig, MaskConfig
    from weaklysuperviseddl_tpu_torch.data.dataset import download_data
    from weaklysuperviseddl_tpu_torch.data.loader import batches
    from weaklysuperviseddl_tpu_torch.masks.densecrf import BACKENDS, densecrf_inference
    from weaklysuperviseddl_tpu_torch.masks.pseudo import (
        ResidentCams,
        _derive_batch,
        extract_cams,
        masks_from_cams,
    )
    from weaklysuperviseddl_tpu_torch.ops.bilateral import gaussian_filter_cuda
    from weaklysuperviseddl_tpu_torch.ops.cam_fusion import cam_fusion_cuda
    from weaklysuperviseddl_tpu_torch.ops.cc import label_components_cuda
    from weaklysuperviseddl_tpu_torch.pipelines.weakly import crf_kwargs

    n, size = 32, 224
    m = MaskConfig()
    kwargs = {be: crf_kwargs(ExperimentConfig(mask=MaskConfig(use_crf=True, crf_backend=be)))
              for be in BACKENDS}
    check(all(kw == {**CRF_REFERENCE, "bilat_backend": be} for be, kw in kwargs.items()),
          f"CRF kwargs {kwargs} are not the reference's")
    model = full_width_classifier(0)
    ds = download_data(None, synthetic_size=n, image_size=size, seed=12)

    # ---- the main path: every count from 0, CAMs then each backend's masks ----
    for kernel in (gaussian_filter_cuda, cam_fusion_cuda):
        kernel.launches = 0
    reset_cc_counts()
    resident = extract_cams(batches(ds, n, pad_to_full=True), model, image_size=size,
                            max_images=n)
    masks = {be: masks_from_cams(resident, cam_thresh=m.cam_thresh, use_crf=True,
                                 crf_kwargs=kw).as_arrays()[1] for be, kw in kwargs.items()}
    torch.cuda.synchronize()
    launches = {"bilateral": gaussian_filter_cuda.launches,
                "cc_label": label_components_cuda.launches,
                "cam_fusion": cam_fusion_cuda.launches}
    want_k3 = 2 * (1 + m.crf_iters)  # attention and subsampled, one batch each
    check(launches["bilateral"] == want_k3,
          f"crf_backends: bilateral launched {launches['bilateral']} times, expected {want_k3}")
    check(launches["cc_label"] == len(BACKENDS),
          f"crf_backends: cc_label launched {launches['cc_label']} times, not {len(BACKENDS)}")
    check_cc_image_plan("crf_backends")

    probs, images = crf_batch_inputs(resident, size, m.cam_thresh)
    cpu_rows = [0, n - 1]
    cpu_res = ResidentCams(resident.images_raw[cpu_rows].cpu(), resident.cams[cpu_rows].cpu(),
                           resident.store_images[cpu_rows].cpu(), size, len(cpu_rows))
    by_backend = {}
    for be, kw in kwargs.items():
        row = {"agreement_with_attention": float((masks[be] == masks["attention"]).mean()),
               "fg_frac": float(masks[be].mean())}
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        row["ms_per_batch32"] = cuda_ms(lambda: _derive_batch(
            resident.images_raw, resident.cams, m.cam_thresh, True, True, size, kw),
            runs=3, warmup=1)
        row["peak_gb"] = torch.cuda.max_memory_allocated() / 2**30
        row["peak_above_start_gb"] = (torch.cuda.max_memory_allocated() - base) / 2**30
        crf = {k: v for k, v in kw.items() if k != "n_iters"}
        q1 = densecrf_inference(probs, images, n_iters=m.crf_iters, **crf)
        q2 = densecrf_inference(probs, images, n_iters=m.crf_iters, **crf)
        row["marginals_bit_equal_across_launches"] = bool(torch.equal(q1, q2))
        row["max_abs_q_between_launches"] = float((q1 - q2).abs().max())
        del q1, q2
        if be in ("grid", "lattice", "rff"):
            t_cpu = time.perf_counter()
            cpu_masks = masks_from_cams(cpu_res, cam_thresh=m.cam_thresh, use_crf=True,
                                        crf_kwargs=kw).as_arrays()[1]
            row["cpu_s_2_images"] = time.perf_counter() - t_cpu
            row["card_vs_cpu_images_0_31"] = float((masks[be][cpu_rows] == cpu_masks).mean())
            gate = 0.99 if be == "rff" else 0.999
            check(row["card_vs_cpu_images_0_31"] >= gate,
                  f"{be} CRF masks, card vs CPU on images 0 and 31: "
                  f"{row['card_vs_cpu_images_0_31']} < {gate}")
        by_backend[be] = row
    check(by_backend["lattice"]["marginals_bit_equal_across_launches"],
          "lattice CRF marginals differ between two launches")
    # RFF's masks are noise at these bandwidths (reported, not checked)
    check(all(0.0 < r["fg_frac"] < 1.0 for be, r in by_backend.items() if be != "rff"),
          f"a backend's masks are empty or full: {by_backend}")
    lattice = lattice_vs_exact(probs, images, CRF_REFERENCE["bilat_sxy"],
                               CRF_REFERENCE["bilat_srgb"])
    emit("crf_backends", entry="masks_from_cams(use_crf=True)", images=n, size=size,
         crf=CRF_REFERENCE, backends=by_backend, lattice=lattice,
         launches_main_path=launches, expected_bilateral_launches=want_k3,
         cpu_gates={"grid": 0.999, "lattice": 0.999, "rff": 0.99})
    return launches


def write_pet_layout(root: pathlib.Path, images: np.ndarray, labels: np.ndarray,
                     trimaps: np.ndarray):
    """A Pet-layout directory: JPEG images cropped to ragged widths (so the
    loader resizes them on the host, as it does real Pet photos), PNG
    trimaps and annotations/trainval.txt (1-indexed classes)."""
    from PIL import Image

    (root / "images").mkdir(parents=True)
    (root / "annotations" / "trimaps").mkdir(parents=True)
    lines = []
    for i in range(images.shape[0]):
        w = images.shape[2] - images.shape[2] // 28 * (i % 6)
        name = f"pet_{i:05d}"
        Image.fromarray(images[i, :, :w]).save(root / "images" / f"{name}.jpg")
        Image.fromarray(trimaps[i, :, :w]).save(root / "annotations" / "trimaps" / f"{name}.png")
        lines.append(f"{name} {int(labels[i]) + 1} 1 1")
    (root / "annotations" / "trainval.txt").write_text("\n".join(lines) + "\n")


def loader_rate(dataset, model, batch_size: int, size: int, use_prefetch: bool) -> float:
    """img/s of batches(dataset) feeding an upload, the preprocessing and
    LayerCAM on the card, with or without prefetch."""
    import torch

    from weaklysuperviseddl_tpu_torch.cam.layercam import layercam
    from weaklysuperviseddl_tpu_torch.data.loader import batches, prefetch
    from weaklysuperviseddl_tpu_torch.data.preprocess import preprocess_batch

    stream = batches(dataset, batch_size, pad_to_full=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = 0
    for batch in (prefetch(stream) if use_prefetch else stream):
        x, _ = preprocess_batch(torch.from_numpy(batch.image).cuda(), None, size=size)
        layercam(model, x, torch.from_numpy(batch.label).cuda(), output_size=size)
        n += batch.num_valid
    torch.cuda.synchronize()
    return n / (time.perf_counter() - t0)


def phase_pseudo_stage():
    import torch

    from weaklysuperviseddl_tpu_torch.data.dataset import download_data
    from weaklysuperviseddl_tpu_torch.data.loader import batches
    from weaklysuperviseddl_tpu_torch.data.mask_store import MaskStore, native_error
    from weaklysuperviseddl_tpu_torch.masks.pseudo import extract_cams, masks_from_cams
    from weaklysuperviseddl_tpu_torch.ops.cc import label_components_cuda

    n, batch_size, size, window = 1024, 32, 224, 8
    model = full_width_classifier(0)
    ds = download_data(None, synthetic_size=n, image_size=size, seed=21)

    def timed_extract(**kw):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = extract_cams(batches(ds, batch_size, pad_to_full=True), model, image_size=size,
                           max_images=None, **kw)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        return res, {"seconds": s, "img_per_s": n / s,
                     "peak_gb": torch.cuda.max_memory_allocated() / 2**30,
                     "peak_above_start_gb": (torch.cuda.max_memory_allocated() - base) / 2**30,
                     "resident_gb": res.resident_bytes() / 2**30}

    def timed_masks(res):
        t0 = time.perf_counter()
        store = masks_from_cams(res)
        s = time.perf_counter() - t0
        return store.as_arrays(), {"seconds": s, "img_per_s": n / s}

    # ---- the main path: the count from 0, both extractions and derivations ----
    reset_cc_counts()
    spilled, spill_stats = timed_extract(spill_to_host=True, batches_per_dispatch=window)
    resident, resident_stats = timed_extract()
    (images_r, masks_r, keys), derive_resident = timed_masks(resident)
    (images_s, masks_s, keys_s), derive_spilled = timed_masks(spilled)
    torch.cuda.synchronize()
    cc_launches = label_components_cuda.launches
    want_cc = 2 * n // batch_size
    check(cc_launches == want_cc, f"pseudo_stage: cc_label launched {cc_launches} times, "
          f"expected {want_cc}")
    check_cc_image_plan("pseudo_stage")
    check(resident.on_device and not spilled.on_device, "pseudo_stage: residency flags")
    # cuDNN's default backward-data kernels add in a varying order, so two
    # runs of one batch differ in the last bits: spilled against resident,
    # and a second resident run against the first, by default; bit-equal
    # with cudnn.deterministic
    default_mode = {
        "cams_max_abs_spilled_vs_resident": float(
            np.abs(spilled.cams - resident.cams.cpu().numpy()).max()),
        "masks_agreement_spilled_vs_resident": float((masks_r == masks_s).mean()),
        "store_images_equal": bool(np.array_equal(images_r, images_s)),
    }
    again, _ = timed_extract()
    default_mode["cams_max_abs_resident_twice"] = float((again.cams - resident.cams).abs().max())
    del again
    check(keys == keys_s and default_mode["masks_agreement_spilled_vs_resident"] >= 0.9999,
          f"spilled masks differ from the resident ones: {default_mode}")
    fg = float(masks_r.mean())
    check(0.01 < fg < 0.99, f"pseudo_stage masks are empty or full: {fg}")
    del spilled
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        res_d, det_resident = timed_extract()
        spill_d, det_spilled = timed_extract(spill_to_host=True, batches_per_dispatch=window)
        det_masks = [masks_from_cams(r).as_arrays() for r in (res_d, spill_d)]
    finally:
        torch.backends.cudnn.deterministic = prev
    check(np.array_equal(spill_d.cams, res_d.cams.cpu().numpy())
          and np.array_equal(spill_d.store_images, res_d.store_images.cpu().numpy()),
          "with cudnn.deterministic, spilled CAMs differ from the resident ones")
    check(det_masks[0][2] == det_masks[1][2]
          and all(np.array_equal(a, b) for a, b in zip(det_masks[0][:2], det_masks[1][:2])),
          "with cudnn.deterministic, spilled masks differ from the resident ones")
    deterministic = {"cams_and_masks_bit_equal": True,
                     "extract_resident_img_per_s": det_resident["img_per_s"],
                     "extract_spilled_img_per_s": det_spilled["img_per_s"]}
    del res_d, spill_d, det_masks

    try:
        import PIL  # noqa: F401
    except ImportError:
        PIL = None
    store_dir = CKPT_ROOT / "pseudo_stage"
    shutil.rmtree(store_dir, ignore_errors=True)
    store = MaskStore(str(store_dir))
    t0 = time.perf_counter()
    for i, key in enumerate(keys):
        store.put(key, images_r[i], masks_r[i])
    submit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    store.flush()
    flush_s = time.perf_counter() - t0
    store_line = {"writer": store.writer, "native_error": native_error(), "pairs": n,
                  "submit_s": submit_s, "flush_s": flush_s,
                  "mb_on_disk": sum(f.stat().st_size for f in store_dir.rglob("*.png")) / 2**20}
    if PIL is not None:
        t0 = time.perf_counter()
        loaded_images, loaded_masks, loaded_keys = MaskStore.load(str(store_dir)).as_arrays()
        store_line["load_s"] = time.perf_counter() - t0
        check(loaded_keys == keys and np.array_equal(loaded_masks, masks_r)
              and np.array_equal(loaded_images, images_r),
              "MaskStore.load of the directory differs from the arrays")
    else:
        store_line["load"] = "skipped: no PIL on this host"
    shutil.rmtree(store_dir, ignore_errors=True)

    disk = {"skipped": "no PIL on this host"}
    if PIL is not None:
        root = CKPT_ROOT / "pet"
        shutil.rmtree(root, ignore_errors=True)
        n_disk, limit = 300, 256
        synth = np.stack(ds.images[:n_disk]).astype(np.uint8)
        write_pet_layout(root, synth, ds.labels[:n_disk], np.stack(ds.trimaps[:n_disk]))
        t0 = time.perf_counter()
        pets_disk = download_data(str(root), limit=limit)
        decode_s = time.perf_counter() - t0
        check(len(pets_disk) == limit, f"download_data(limit={limit}) gave {len(pets_disk)}")
        loader_rate(pets_disk, model, batch_size, size, True)  # warm-up
        plain = loader_rate(pets_disk, model, batch_size, size, False)
        prefetched = loader_rate(pets_disk, model, batch_size, size, True)
        disk = {"images": limit, "decode_s": decode_s, "decode_img_per_s": limit / decode_s,
                "batches_img_per_s": plain, "batches_prefetch_img_per_s": prefetched,
                "from_disk_img_per_s": limit / (decode_s + limit / plain),
                "from_disk_prefetch_img_per_s": limit / (decode_s + limit / prefetched)}
        shutil.rmtree(root, ignore_errors=True)
    emit("pseudo_stage", entry="extract_cams + masks_from_cams", images=n,
         batch_size=batch_size, size=size, batches_per_dispatch=window,
         extract_resident=resident_stats, extract_spilled=spill_stats,
         derive_resident=derive_resident, derive_spilled=derive_spilled,
         default_mode=default_mode, cudnn_deterministic=deterministic, fg_frac=fg,
         store=store_line, disk_loader=disk,
         launches_main_path={"cc_label": cc_launches})
    return {"cc_label": cc_launches}


MESH_KERNELS = ("cc_label", "bilateral", "refine", "quantize_gather", "dequant_epilogue")


def mesh_counts() -> dict:
    """The launch counts of the kernels the mesh path runs (and the int32 GEMM's)."""
    return {k: v for k, v in kernel_counts().items() if k in MESH_KERNELS + ("int8_gemm",)}


def mesh_store(n: int, size: int, seed: int):
    """An in-memory MaskStore of ``n`` synthetic pets at ``size``², each
    mask its trimap's foreground (the alternating loop's input)."""
    from weaklysuperviseddl_tpu_torch.data.dataset import download_data
    from weaklysuperviseddl_tpu_torch.data.mask_store import MaskStore

    ds = download_data(None, split="train", synthetic_size=n, image_size=size, seed=seed)
    store = MaskStore()
    for i in range(n):
        store.put(f"{i:04d}", np.asarray(ds.images[i], np.uint8),
                  (np.asarray(ds.trimaps[i]) == 1).astype(np.uint8))
    return store


def mesh_rank() -> dict:
    """The mesh phase on one rank of the NCCL group (all of it on one card).

    The path, the counts set to 0 just before it and read just after: the
    dryrun (parallel/dryrun.py); the alternating loop on the mesh
    (run_alternating_training(mesh=)) with the full-width DeepLabV3 at 256²
    over 8 pets; Predictor(mesh=) on a local mesh of the visible cards,
    float32 and int8, clean and packed, at the full width. Then, outside the
    path: the one-device Predictor on the same requests (bit-equal), the
    sharded segmentation step against the one-device step from the same
    seed, and refine_spatial_sharded at 1024² against refine_plain."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from weaklysuperviseddl_tpu_torch.config import AlternatingConfig, ExperimentConfig
    from weaklysuperviseddl_tpu_torch.models.deeplabv3 import DeepLabV3, seed_dropout
    from weaklysuperviseddl_tpu_torch.ops.refine import refine_cuda, refine_plain
    from weaklysuperviseddl_tpu_torch.parallel.dryrun import dryrun_multichip
    from weaklysuperviseddl_tpu_torch.parallel.mesh import (
        is_main_rank,
        make_mesh,
        shard_batch,
        visible_cards,
    )
    from weaklysuperviseddl_tpu_torch.parallel.spatial import refine_spatial_sharded, shard_spatial
    from weaklysuperviseddl_tpu_torch.pipelines.serve import Predictor
    from weaklysuperviseddl_tpu_torch.train.alternating import run_alternating_training
    from weaklysuperviseddl_tpu_torch.train.segmentation import create_seg_state, seg_train_step
    from weaklysuperviseddl_tpu_torch.utils.profiling import Stopwatch

    world = dist.get_world_size()
    out: dict = {"world": world, "backend": dist.get_backend()}
    check(out["backend"] == "nccl", f"the mesh runs on {out['backend']}, not NCCL")
    mesh = make_mesh()  # every rank on 'data', as MeshConfig() places a run
    size, max_batch = 256, 16
    model, _, _ = serve_model()
    requests = pets("test", max_batch, size, seed=31)
    ragged = requests[:5]
    sw = Stopwatch("cuda")
    cfg = dataclasses.replace(ExperimentConfig(), alternating=AlternatingConfig(
        num_alternations=1, epochs_per_round=1, refine_repeats=1))
    store = mesh_store(8, 224, seed=33)

    # ---- the main path: every count from 0, the path, the counts read after ----
    reset_kernel_counts()
    t0 = time.perf_counter()
    dry = dryrun_multichip(log=lambda line: print(line, flush=True), stopwatch=sw)
    state = create_seg_state(DeepLabV3(2, 50, 1.0), seed=cfg.seed + 1, lr=cfg.seg.lr, mesh=mesh)
    with sw.phase("alternating"):
        run_alternating_training(state, store, cfg, mesh=mesh, stopwatch=sw,
                                 log=lambda *a: None)
    served = {}
    if is_main_rank():
        local = make_mesh(devices=visible_cards())
        for kind in ("float32", "int8"):
            pred = Predictor(model, size=size, max_batch=max_batch, clean=True, packed=True,
                             mesh=local)
            if kind == "int8":
                pred.quantize(requests)
            with sw.phase(f"serve_{kind}", images=max_batch + len(ragged)):
                served[kind] = (pred(requests), pred(ragged))
    dist.barrier()
    torch.cuda.synchronize()
    out["path_seconds"] = time.perf_counter() - t0
    out["launches"] = launches = mesh_counts()
    plans = dict(refine_cuda.plan_launches)
    out["dryrun"] = dry
    out["stage_seconds"] = dict(sw.times)
    check(launches["bilateral"] == 2 * (1 + 2),
          f"the dryrun's two CRFs (2 iterations each) launched bilateral "
          f"{launches['bilateral']} times, not 6")
    check(launches["refine"] == -(-len(store) // cfg.seg.batch_size)
          and plans["v1sym"] == launches["refine"],
          f"the sweep launched refine {launches['refine']} times, by plan {plans}")
    if is_main_rank():
        check(all(launches[k] > 0 for k in MESH_KERNELS), f"mesh path launches {launches}")
        check_cc_image_plan("mesh")

    # ---- the one-device Predictor on the same requests: bit-equal ----
    if is_main_rank():
        for kind, (full, part) in served.items():
            one = Predictor(model, size=size, max_batch=max_batch, clean=True, packed=True,
                            device="cuda")
            if kind == "int8":
                one.quantize(requests)
            check(np.array_equal(one(requests), full) and np.array_equal(one(ragged), part),
                  f"Predictor(mesh=) {kind} masks differ from the one-device Predictor's")
        out["serving_bit_equal"] = ["float32", "int8"]

    # ---- the sharded step against the one-device step from the same seed ----
    # At a world of 1 the sharded step runs the one-device code: its forward
    # (the loss, BatchNorm's statistics) must give the same bits. Its
    # parameters may not: the backward of the bilinear resize and of the
    # pooling add with atomics in any order, so two one-device steps differ
    # as well; the sharded step's distance is reported beside theirs.
    rs = np.random.default_rng(5)
    batch = 4 * mesh.data
    x = rs.standard_normal((batch, size, size, 3)).astype(np.float32)
    m = rs.integers(0, 2, (batch, size, size)).astype(np.int32)
    v = np.arange(batch) < batch - 1

    def step(sharded: bool):
        st = create_seg_state(DeepLabV3(2, 50, 1.0), seed=7,
                              **({"mesh": mesh} if sharded else {"device": "cuda"}))
        seed_dropout(st.model, 11)
        inputs = (shard_batch(mesh, x, m, v) if sharded
                  else [torch.from_numpy(a).cuda() for a in (x, m, v)])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss = float(seg_train_step(st, *inputs, mesh=mesh if sharded else None))
        return loss, (time.perf_counter() - t1) * 1e3, st.model.state_dict()

    def distance(a, b, buffers: bool):
        return max(float((a[k].double() - b[k].double()).abs().max()) for k in a
                   if k.endswith(("running_mean", "running_var")) == buffers)

    torch.backends.cudnn.deterministic = True  # cuDNN's default backward-data adds in any order
    try:
        step(False)  # cuDNN's plans and the allocator, before the timed steps
        loss_s, out["sharded_step_ms"], state_s = step(True)
        loss_1, out["one_device_step_ms"], state_1 = step(False)
        loss_2, _, state_2 = step(False)
    finally:
        torch.backends.cudnn.deterministic = False
    out["step_losses"] = [loss_s, loss_1, loss_2]
    out["step_param_max_abs_diff"] = {"sharded_vs_one_device": distance(state_s, state_1, False),
                                      "one_device_vs_itself": distance(state_2, state_1, False)}
    if world == 1:
        check(loss_s == loss_1 == loss_2 and distance(state_s, state_1, True) == 0.0,
              f"the world-1 sharded step's forward is not the one-device step's: losses "
              f"{out['step_losses']}, statistics {distance(state_s, state_1, True)}")
        # Adam's first step moves a parameter by at most about lr (1e-4)
        check(out["step_param_max_abs_diff"]["sharded_vs_one_device"] <= 2.5e-4,
              f"parameters after the step {out['step_param_max_abs_diff']}")
    else:  # another batch split: the global batch's statistics, summed in another order
        check(abs(loss_s - loss_1) <= 1e-4 * abs(loss_1), f"step losses {out['step_losses']}")

    # ---- refine_spatial_sharded at JAX's 1024² against the unsharded refinement ----
    rr = np.random.default_rng(4)
    S = rr.uniform(0.1, 1, (1, 1024, 1024, 2)).astype(np.float32)
    S /= S.sum(-1, keepdims=True)
    images = rr.uniform(-1, 1, (1, 1024, 1024, 3)).astype(np.float32)
    masks = (rr.uniform(0, 1, (1, 1024, 1024)) > 0.5).astype(np.int32)
    kw = dict(lambda_boundary=0.1, threshold=0.5, lr=1e-2, num_steps=3, sigma_color=0.1,
              window_size=5, loss="ncut")
    t1 = time.perf_counter()
    rows, loss_sh = refine_spatial_sharded(*(shard_spatial(mesh, a) for a in (S, images, masks)),
                                           mesh, **kw)
    torch.cuda.synchronize()
    out["spatial_ms"] = (time.perf_counter() - t1) * 1e3
    got = torch.empty((world, *rows.shape), dtype=rows.dtype, device=rows.device)
    dist.all_gather_into_tensor(got, rows.contiguous())
    t1 = time.perf_counter()
    want, loss_pl = refine_plain(*(torch.from_numpy(a).cuda() for a in (S, images, masks)), **kw)
    torch.cuda.synchronize()
    out["spatial_plain_ms"] = (time.perf_counter() - t1) * 1e3
    got = got.permute(1, 0, 2, 3).reshape(want.shape)
    out["spatial_loss"] = [float(loss_sh), float(loss_pl)]
    out["spatial_mask_agreement"] = float((got == want).float().mean())
    check(abs(float(loss_sh) - float(loss_pl)) <= 1e-4 * abs(float(loss_pl)),
          f"sharded refinement loss {float(loss_sh)} against {float(loss_pl)}")
    check(out["spatial_mask_agreement"] > 0.999,
          f"sharded refinement masks agree on {out['spatial_mask_agreement']}")
    return out


def phase_mesh():
    """The ('data', 'model') mesh under NCCL with a world of every visible
    card: in this process on one card, else one spawned rank a card
    (rank 0's figures). Any failure, NCCL's init included, fails the phase."""
    import tempfile

    import torch
    import torch.distributed as dist

    from weaklysuperviseddl_tpu_torch.parallel.mesh import init_distributed, spawn

    world = torch.cuda.device_count()
    if world > 1:
        out = spawn(mesh_rank, world, "cuda")[0]
    else:
        with tempfile.TemporaryDirectory() as rendezvous:
            init_distributed("cuda", 0, 1, f"file://{rendezvous}/store")
            try:
                out = mesh_rank()
            finally:
                dist.destroy_process_group()
    emit("mesh", **out)
    return out["launches"]



# SAM's hypernetwork output layer is scaled by this at random weights, whose
# largest logit (0.03) stays under the pipeline's 0.5 threshold: the masks
# then hold both values on the main path and in the card-against-CPU check
FOUNDATION_MASK_GAIN = 100.0
FEW_BOXES = 3  # the pipeline timed again at a trained detector's box count
FOUNDATION_VOCAB_IDS = {"[PAD]": 0, "[UNK]": 100, "[CLS]": 101, "[SEP]": 102, "[MASK]": 103,
                        ".": 1012, "?": 1029, "a": 1037, "an": 2019, "dog": 3899,
                        "animal": 4111, "cat": 4937}


def foundation_vocab() -> list[str]:
    """BERT-base's 30522 entries for the full-width detector: the JAX package's
    test words, the special tokens at the ids of models/gdino/bert.py's
    SPECIAL_TOKENS (so "a cat. a dog." splits into its two phrases), and
    "[unusedN]" everywhere else."""
    vocab = [f"[unused{i}]" for i in range(30522)]
    for tok, i in FOUNDATION_VOCAB_IDS.items():
        vocab[i] = tok
    return vocab


def kernel_counts() -> dict:
    """Every kernel counter of the port, under the kernels line's names (the
    16-bit cam_fusion rows count the launches on their dtype)."""
    from weaklysuperviseddl_tpu_torch.ops.bilateral import gaussian_filter_cuda
    from weaklysuperviseddl_tpu_torch.ops.cam_fusion import cam_fusion_cuda
    from weaklysuperviseddl_tpu_torch.ops.cc import label_components_cuda
    from weaklysuperviseddl_tpu_torch.ops.refine import refine_cuda
    from weaklysuperviseddl_tpu_torch.ops.window import window_sum_cuda, window_sum_grad_cuda

    return {"cc_label": label_components_cuda.launches, "refine": refine_cuda.launches,
            "refine_v2_aff": refine_cuda.plan_launches["v2_aff"],
            "window_fwd": window_sum_cuda.launches, "window_bwd": window_sum_grad_cuda.launches,
            "bilateral": gaussian_filter_cuda.launches,
            "cam_fusion": cam_fusion_cuda.launches,
            "cam_fusion_bf16": cam_fusion_cuda.launches_by_dtype["bfloat16"],
            "cam_fusion_fp16": cam_fusion_cuda.launches_by_dtype["float16"], **qconv_counts()}


def reset_kernel_counts():
    """Every counter kernel_counts() reads, set to 0."""
    from weaklysuperviseddl_tpu_torch.ops.bilateral import gaussian_filter_cuda
    from weaklysuperviseddl_tpu_torch.ops.cam_fusion import cam_fusion_cuda
    from weaklysuperviseddl_tpu_torch.ops.window import window_sum_cuda, window_sum_grad_cuda

    reset_cc_counts()
    reset_refine_counts()
    reset_qconv_counts()
    for fn in (window_sum_cuda, window_sum_grad_cuda, gaussian_filter_cuda, cam_fusion_cuda):
        fn.launches = 0
    cam_fusion_cuda.launches_by_dtype = dict.fromkeys(cam_fusion_cuda.launches_by_dtype, 0)


def staged_ms(stages, runs: int = 5) -> dict:
    """Median device ms of each named stage: ``stages()`` yields (name, out)
    as each stage's work is queued; a CUDA event is recorded after each; one
    warm-up run."""
    import torch

    times: dict[str, list[float]] = {}
    for r in range(runs + 1):
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        marks = []
        for name, _ in stages():
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            marks.append((name, e))
        torch.cuda.synchronize()
        if r == 0:
            continue
        prev = start
        for name, e in marks:
            times.setdefault(name, []).append(prev.elapsed_time(e))
            prev = e
    out = {k: statistics.median(v) for k, v in times.items()}
    out["total"] = sum(out.values())
    return out


def detector_stages(det, image, prompts):
    import torch

    def stages():
        inputs = det.preprocess(image, prompts)
        yield "preprocess", inputs
        with torch.no_grad():
            for name, out in det.model.stages(inputs["pixel_values"], inputs["input_ids"],
                                              inputs["token_type_ids"],
                                              inputs["attention_mask"], inputs["pixel_mask"]):
                yield name, out
        yield "postprocess", det.postprocess(out[0], out[1], image.shape[:2])
    return stages


def segmenter_stages(seg, image, boxes):
    import torch

    def stages():
        pixel_values, input_boxes = seg.preprocess(image, boxes)
        yield "preprocess", pixel_values
        with torch.no_grad():
            emb = seg.model.vision_encoder(pixel_values)
            yield "image_encoder", emb
            yield "prompt_and_mask_decoder", seg.model.decode(emb, input_boxes)
    return stages


def gdino_selection(det, image, prompts):
    """One image through the detector's stages: (the chosen proposals [Q],
    every proposal's best logit [S] on the CPU, the kept boxes in pixels by
    proposal index, the detector's output: the kept boxes in query order)."""
    import torch

    stage = dict(detector_stages(det, image, prompts)())
    logits, boxes, topk, best = stage["decoder"]
    kept = torch.sigmoid(logits[0]).max(-1)[0] > det.box_threshold
    px = torch.from_numpy(det.postprocess(logits, boxes, image.shape[:2]))
    idx = [i for i, k in zip(topk[0].tolist(), kept.tolist()) if k]
    return topk[0].tolist(), best[0].cpu(), dict(zip(idx, px)), stage["postprocess"]


class RecordingSegmenter:
    """A SamSegmenter that keeps every call's boxes and raw outputs."""

    def __init__(self, seg):
        self.seg, self.calls = seg, []

    def __call__(self, image, boxes):
        iou, masks = self.seg.raw(image, boxes)
        self.calls.append((boxes, iou, masks))
        return masks[:, 0].cpu().numpy().squeeze(0)


def phase_foundation():
    """The foundation baseline at full width (facebook/sam-vit-base and
    IDEA-Research/grounding-dino-base shapes, seeded random weights, SAM's
    hypernetwork output scaled by FOUNDATION_MASK_GAIN) through
    evaluate_pipeline_on_dataset on 16 synthetic pets, at the reference's
    thresholds and again with the detector's boxes cut to FEW_BOXES (random
    weights put ~700 of 900 queries over 0.3; a trained detector keeps a
    few); stage times; the card against the CPU on one image."""
    import copy
    import math

    import torch

    from weaklysuperviseddl_tpu_torch.data.dataset import download_data
    from weaklysuperviseddl_tpu_torch.models.foundation_config import (
        grounding_dino_base,
        sam_vit_base,
    )
    from weaklysuperviseddl_tpu_torch.pipelines import foundation as F

    n_pets, size, prompts = 16, 224, F.DEFAULT_PROMPTS

    def build(device):
        det = F.hf_detector(config=grounding_dino_base(), vocab=foundation_vocab(),
                            device=device, generator=torch.Generator().manual_seed(0))
        seg = F.hf_segmenter(config=sam_vit_base(), device=device,
                             generator=torch.Generator().manual_seed(1))
        with torch.no_grad():
            for mlp in seg.model.mask_decoder.output_hypernetworks_mlps:
                mlp.proj_out.weight.mul_(FOUNDATION_MASK_GAIN)
        return det, seg

    t0 = time.perf_counter()
    det, seg = build("cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    dataset = download_data(None, split="test", synthetic_size=n_pets, image_size=size)
    image0 = np.asarray(dataset[0][0])
    boxes_per_image = []

    def counting_detector(image, p):
        boxes = det(image, p)
        boxes_per_image.append(len(boxes))
        return boxes

    pipe = F.FoundationPipeline(detector=counting_detector, segmenter=seg, output_size=224)
    t0 = time.perf_counter()
    card_mask = pipe.run_segmentation_pipeline(image0)  # also the warm-up
    torch.cuda.synchronize()
    first_image_s = time.perf_counter() - t0
    boxes_per_image.clear()

    out_dir = CKPT_ROOT / "foundation_masks"
    shutil.rmtree(out_dir, ignore_errors=True)
    logs = []
    reset_kernel_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    iou, acc = F.evaluate_pipeline_on_dataset(dataset, pipe, num_images=n_pets,
                                              save_dir=str(out_dir), log=logs.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    check(not any(launches.values()), f"a kernel launched on the foundation path: {launches}")
    files = sorted(os.listdir(out_dir))
    masks = [f for f in files if f.startswith("mask_")]
    predicted = n_pets - sum("No prediction made" in line for line in logs)
    check(len(boxes_per_image) == n_pets and len(masks) == predicted,
          f"{len(masks)} mask PNGs for {predicted} predictions")
    check(math.isfinite(iou) and 0 <= iou <= 1 and 0 <= acc <= 1, f"IoU {iou}, accuracy {acc}")
    check(card_mask is not None and card_mask.shape == (224, 224), "image 0 has a mask")
    mask_frac = float(card_mask.mean())
    check(0 < mask_frac < 1, f"image 0's mask holds one value (foreground {mask_frac})")

    # the same pipeline at a trained detector's few boxes an image: the
    # detector's boxes cut to their first FEW_BOXES (random weights saturate
    # the scores at 1.0, so no threshold keeps a few)
    few_boxes = []

    def few_detector(image, p):
        boxes = det(image, p)[:FEW_BOXES]
        few_boxes.append(len(boxes))
        return boxes

    few_pipe = F.FoundationPipeline(detector=few_detector, segmenter=seg, output_size=224)
    few_pipe.run_segmentation_pipeline(image0)  # warm-up at this box count
    few_boxes.clear()
    few_logs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    few_iou, few_acc = F.evaluate_pipeline_on_dataset(
        dataset, few_pipe, num_images=n_pets, save_dir=str(CKPT_ROOT / "foundation_masks_few"),
        log=few_logs.append)
    torch.cuda.synchronize()
    few_wall = time.perf_counter() - t0
    check(few_boxes == [FEW_BOXES] * n_pets and math.isfinite(few_iou),
          f"{few_boxes} boxes at the cut detector, IoU {few_iou}")

    detector_ms = staged_ms(detector_stages(det, image0, prompts))
    boxes0 = det(image0, prompts)
    segmenter_ms_1 = staged_ms(segmenter_stages(seg, image0, boxes0[:1]))
    segmenter_ms_n = staged_ms(segmenter_stages(seg, image0, boxes0), runs=3)

    # the card against the CPU, one image, the same weights (copied off the card)
    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    det_cpu = F.GroundingDinoDetector(copy.deepcopy(det.model).to(cpu), det.tokenizer, det.size,
                                      det.box_threshold, det.text_threshold, cpu)
    seg_cpu = F.SamSegmenter(copy.deepcopy(seg.model).to(cpu), seg.image_size, cpu)
    seg_cpu.model.tie_weights()
    cpu_s = {"copy": time.perf_counter() - t0}
    idx_card, best_card, kept_card, _ = gdino_selection(det, image0, prompts)
    t0 = time.perf_counter()
    idx_cpu, best_cpu, kept_cpu, boxes_cpu = gdino_selection(det_cpu, image0, prompts)
    cpu_s["detector"] = time.perf_counter() - t0
    Q = len(idx_card)
    cut_card = best_card.topk(Q).values[-1].item()
    cut_cpu = best_cpu.topk(Q).values[-1].item()
    swapped = sorted(set(idx_card) ^ set(idx_cpu))
    swap_gap = max([min(abs(best_card[i].item() - cut_card), abs(best_cpu[i].item() - cut_cpu))
                    for i in swapped], default=0.0)
    check(swap_gap <= 1e-5, f"top-{Q} proposals differ away from the cut: {len(swapped)} "
          f"swapped, {swap_gap} from it")
    both = sorted(kept_card.keys() & kept_cpu.keys())
    box_err = max([(kept_card[i] - kept_cpu[i]).abs().max().item() for i in both], default=0.0)
    check(both and box_err <= 1e-2, f"{len(both)} boxes kept by both, {box_err} px apart")

    # the CPU pipeline on that image, its detector's output taken from the run above
    recording = RecordingSegmenter(seg_cpu)
    t0 = time.perf_counter()
    cpu_mask = F.FoundationPipeline(lambda image, p: boxes_cpu, recording,
                                    224).run_segmentation_pipeline(image0)
    cpu_s["segmenter"] = time.perf_counter() - t0
    cpu_boxes, cpu_iou, cpu_logits = recording.calls[0]
    card_iou, card_logits = seg.raw(image0, cpu_boxes)
    logit_err = (card_logits.cpu() - cpu_logits).abs().max().item()
    logit_scale = cpu_logits.abs().max().item()
    check(logit_err <= 1e-3 * logit_scale, f"SAM logits {logit_err} apart (largest {logit_scale})")
    agree = float((card_mask == cpu_mask).mean())
    check(agree >= 0.999, f"pipeline masks agree on {agree} of the pixels")

    boxes_mean = float(np.mean(boxes_per_image))
    emit("foundation",
         entry="evaluate_pipeline_on_dataset(dataset, FoundationPipeline(hf_detector(config="
               "grounding_dino_base()), hf_segmenter(config=sam_vit_base())))",
         models={"detector": "GroundingDINO-base shapes: Swin-B 384 (window 12), BERT-base "
                             "(vocab 30522), d_model 256, 900 queries, 6+6 layers, 4 levels",
                 "segmenter": "SAM ViT-B: 768 wide, 12 layers, 1024², window 14",
                 "weights": "random, transformers' scheme, torch.Generator seeds 0 and 1"},
         pets=n_pets, image_size=size, prompts=list(prompts),
         box_threshold=det.box_threshold, text_threshold=det.text_threshold,
         detector_input=list(det.preprocess(image0, prompts)["pixel_values"].shape),
         build_s=build_s, first_image_s=first_image_s, wall_s=wall, img_per_s=n_pets / wall,
         boxes_per_image=boxes_per_image, boxes_per_image_mean=boxes_mean,
         predictions=predicted, masks_written=len(masks),
         figures_written=len([f for f in files if f.startswith("viz_")]),
         iou=iou, accuracy=acc, peak_mem_gb=peak_gb, launches=launches,
         mask_gain=FOUNDATION_MASK_GAIN, image0_mask_foreground=mask_frac,
         few_boxes={"boxes_per_image": FEW_BOXES, "wall_s": few_wall,
                    "img_per_s": n_pets / few_wall,
                    "predictions": n_pets - sum("No prediction made" in line
                                                for line in few_logs),
                    "iou": few_iou, "accuracy": few_acc},
         detector_ms=detector_ms, segmenter_ms_1_box=segmenter_ms_1,
         segmenter_ms_all_boxes={"boxes": len(boxes0), **segmenter_ms_n},
         card_vs_cpu={"topk": Q, "swapped_at_cut": len(swapped), "swap_gap": swap_gap,
                      "boxes_card": len(kept_card), "boxes_cpu": len(kept_cpu),
                      "boxes_both": len(both), "box_max_px": box_err,
                      "sam_boxes": len(cpu_boxes), "sam_logit_max_err": logit_err,
                      "sam_logit_largest": logit_scale, "mask_agreement": agree,
                      "cpu_side_s": cpu_s, "cpu_threads": torch.get_num_threads()},
         nvidia_smi=subprocess.run(
             ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
             capture_output=True, text=True, timeout=60).stdout.strip())
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one", file=sys.stderr)
        return 1
    import weaklysuperviseddl_tpu_torch  # noqa: F401  (fails here, before any output, outside a checkout)

    seconds, t_start = {}, time.perf_counter()
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    try:
        return run_phases(seconds, t_start)
    finally:
        shutil.rmtree(CKPT_ROOT, ignore_errors=True)


def run_phases(seconds: dict, t_start: float) -> int:
    import torch

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    smi = timed("device", phase_device)
    timed("build", phase_build)
    max_err = timed("cc", phase_cc)
    launches, served_masks = timed("serve", phase_serve)
    timed("goldens", phase_goldens, served_masks)
    int8_launches, int8_sites, int8_breakdown = timed("serve_int8", phase_serve_int8)
    refine_timing, path_batch, batch8 = timed("refine", phase_refine)
    window = timed("window", phase_window, path_batch, batch8)
    del path_batch, batch8
    weakly_launches, weakly_run = timed("weakly", phase_weakly)
    crf_timing = timed("crf", phase_crf)
    fusion = timed("cam_fusion", phase_cam_fusion)
    crf_launches = timed("weakly_crf", phase_weakly_crf)
    boundary_launches = timed("weakly_boundary", phase_weakly_boundary)
    resume_launches = timed("weakly_resume", phase_weakly_resume, weakly_run)
    serve_ckpt_launches = timed("serve_checkpoint", phase_serve_checkpoint, weakly_run)
    fp32_masks = weakly_run["masks"]
    del weakly_run
    shutil.rmtree(CKPT_ROOT)
    timed("supervised", phase_supervised)
    ablation_launches = timed("ablations", phase_ablations)
    timed("basnet", phase_basnet)
    half = timed("bf16", phase_bf16, fp32_masks)
    fusion_bf16, fusion_fp16 = half["bfloat16"], half["float16"]
    backends_launches = timed("crf_backends", phase_crf_backends)
    pseudo_launches = timed("pseudo_stage", phase_pseudo_stage)
    compat_launches = timed("compat", phase_compat)
    mesh_launches = timed("mesh", phase_mesh)
    foundation_launches = timed("foundation", phase_foundation)

    from weaklysuperviseddl_tpu_torch.masks.components import label_components
    from weaklysuperviseddl_tpu_torch.ops.cc import label_components_cuda, plan_for

    def by_path(name, **paths):
        paths["weakly_crf"] = crf_launches.get(name, 0)
        paths["weakly_boundary"] = boundary_launches.get(name, 0)
        for path, counts in (("weakly_resume", resume_launches),
                             ("serve_checkpoint", serve_ckpt_launches),
                             ("ablations", ablation_launches),
                             ("compat", compat_launches),
                             ("crf_backends", backends_launches),
                             ("pseudo_stage", pseudo_launches),
                             ("mesh", mesh_launches)):
            if name in counts:
                paths[path] = counts[name]
        return {"launches": sum(paths.values()), "launches_by_path": paths}

    def timed_fields(t):
        return {k: t[k] for k in ("ms", "back_to_back_ms", "device_ms", "host_ms", "plain_ms",
                                  "bound_ms", "bound_by")}

    # cc: on the masks the serving path gave it, the served argmax [64,256,256]
    shape = tuple(served_masks.shape)
    kernel_line = {"kernels": [{
        "name": "cc_label",
        "route": "cuda",
        "source": "weaklysuperviseddl_tpu_torch/csrc/cc.cu",
        "replaces": "weaklysuperviseddl_tpu/ops/pallas_cc.py:29",
        **by_path("cc_label", serve=launches, serve_int8=int8_launches["cc_label"],
                  weakly=weakly_launches["cc_label"],
                  bf16=fusion_bf16["cycle_launches"]["cc_label"],
                  fp16=fusion_fp16["cycle_launches"]["cc_label"]),
        "max_abs_err": max_err,
        **kernel_ms(lambda: label_components_cuda(served_masks), runs=25, warmup=3),
        "host_ms": host_ms(lambda: label_components_cuda(served_masks), runs=25),
        "plain_ms": cuda_ms(lambda: label_components(served_masks), runs=20, warmup=1),
        "bound_ms": cc_bound_ms(shape),
        "bound_by": "bytes",
        "library_ms": None,  # no single PyTorch call labels connected components
        "shape": list(shape),
        "plan": plan_for(*shape[1:]),  # every path launch took it (checked in each phase)
    }, {
        "name": "refine",
        "route": "cuda",
        "source": "weaklysuperviseddl_tpu_torch/csrc/refine.cu",
        "replaces": "weaklysuperviseddl_tpu/ops/pallas_refine.py:45",
        **by_path("refine", weakly=weakly_launches["refine"],
                  bf16=fusion_bf16["cycle_launches"]["refine"],
                  fp16=fusion_fp16["cycle_launches"]["refine"]),
        # C=2 on every path; each path phase checks its launches were all v1sym
        "plan_auto_ran": "v1sym",
        "max_abs_err": refine_timing["max_abs_err"],  # of the loss; masks equal or >= 0.9999
        **timed_fields(refine_timing),  # plan "auto" (v1sym)
        "ms_v1": refine_timing["ms_v1"],
        "library_ms": None,  # no single PyTorch call computes the refinement
        "shape": refine_timing["shape"],
    }, {
        "name": "refine_v2_aff",
        "route": "cuda",
        "source": "weaklysuperviseddl_tpu_torch/csrc/refine.cu",
        "replaces": "weaklysuperviseddl_tpu/ops/pallas_refine.py:230",
        # the full-width plan comparisons of the refine phase; no pipeline runs v2_aff
        "launches": refine_timing["v2_aff_launches"],
        "launches_by_path": {"refine_plans": refine_timing["v2_aff_launches"]},
        "max_abs_err": refine_timing["max_abs_err"],  # of the loss, every plan against plain
        "ms": refine_timing["ms_v2_aff"],
        "back_to_back_ms": refine_timing["back_to_back_ms_v2_aff"],
        "device_ms": refine_timing["device_ms_v2_aff"],
        "host_ms": refine_timing["host_ms_v2_aff"],
        "plain_ms": refine_timing["plain_ms"],
        "bound_ms": refine_timing["bound_ms"],  # the function is K1's
        "bound_by": refine_timing["bound_by"],
        "library_ms": None,  # no single PyTorch call computes the refinement
        "shape": refine_timing["shape"],
    }, {
        "name": "window_fwd",
        "route": "cuda",
        "source": "weaklysuperviseddl_tpu_torch/csrc/window.cu",
        "replaces": "weaklysuperviseddl_tpu/ops/pallas_window.py:61",
        # the window phase's autograd refinements (20 + 75 Adam steps, one image)
        "launches": window["launches"]["window_fwd"],
        "launches_by_path": {"window": window["launches"]["window_fwd"]},
        "max_abs_err": window["max_abs_err"]["value"],  # of the losses, against plain
        **window["fwd"],
        "host_ms": window["fwd_host_ms"],
        "plain_ms": window["fwd_plain_ms"],
        "bound_ms": window["fwd_bound_ms"],
        "bound_by": window["fwd_bound_by"],
        "library_ms": None,  # no single PyTorch call computes the window sum
        "shape": window["shape"],
    }, {
        "name": "window_bwd",
        "route": "cuda",
        "source": "weaklysuperviseddl_tpu_torch/csrc/window.cu",
        "replaces": "weaklysuperviseddl_tpu/ops/pallas_window.py:82",
        "launches": window["launches"]["window_bwd"],
        "launches_by_path": {"window": window["launches"]["window_bwd"]},
        "max_abs_err": window["max_abs_err"]["grad"],  # of the losses' gradients
        **window["bwd"],
        "host_ms": window["bwd_host_ms"],
        "plain_ms": window["bwd_plain_ms"],
        "bound_ms": window["bwd_bound_ms"],
        "bound_by": window["bwd_bound_by"],
        "library_ms": None,  # no single PyTorch call computes the window gradient
        "shape": window["shape"],
    }, {
        "name": "bilateral",
        "route": "cuda",
        "source": "weaklysuperviseddl_tpu_torch/csrc/bilateral.cu",
        "replaces": "weaklysuperviseddl_tpu/ops/pallas_bilateral.py:147",
        **by_path("bilateral"),
        "max_abs_err": crf_timing["max_abs_err"],  # at the path's shape, against plain
        **timed_fields(crf_timing),
        "library_ms": None,  # no single PyTorch call computes the Gaussian-kernel filter
        "shape": crf_timing["shape"],  # [B, Nq, Nk, d, C]
    }, {
        "name": "cam_fusion",
        "route": "cuda",
        "source": "weaklysuperviseddl_tpu_torch/csrc/cam_fusion.cu",
        "replaces": "weaklysuperviseddl_tpu/ops/pallas_cam.py:28",
        **by_path("cam_fusion", cam_fusion=fusion["launches"]),
        "max_abs_err": fusion["max_abs_err"],
        **timed_fields(fusion),
        "library_ms": None,  # no single PyTorch call computes the fusion
        "shape": fusion["shape"],  # layer4; layer3 in the cam_fusion line
        "cluster_size": fusion["cluster_size"],  # CTAs an image, one cluster each
    }, {
        "name": "cam_fusion_bf16",
        "route": "cuda",
        "source": "weaklysuperviseddl_tpu_torch/csrc/cam_fusion.cu",
        "replaces": "weaklysuperviseddl_tpu/ops/pallas_cam.py:28",
        # K5 on bfloat16 act and grad (the JAX kernel takes them upcast),
        # launched by layercam(fusion="pallas") on the bfloat16 classifier
        "launches": fusion_bf16["launches"],
        "launches_by_path": {"bf16": fusion_bf16["launches"]},
        "max_abs_err": fusion_bf16["max_abs_err"],  # against plain; bit-equal to the upcasts'
        **timed_fields(fusion_bf16),
        "library_ms": None,  # no single PyTorch call computes the fusion
        "shape": fusion_bf16["shape"],  # layer4; layer3 in the bf16 line
        "cluster_size": fusion_bf16["cluster_size"],
        "float32_kernel_ms": fusion_bf16["float32_kernel_ms"],  # the same call on the upcasts
    }, {
        "name": "cam_fusion_fp16",
        "route": "cuda",
        "source": "weaklysuperviseddl_tpu_torch/csrc/cam_fusion.cu",
        "replaces": "weaklysuperviseddl_tpu/ops/pallas_cam.py:28",
        # K5 on float16 act and grad, launched by layercam(fusion="pallas") on
        # the float16 classifier
        "launches": fusion_fp16["launches"],
        "launches_by_path": {"fp16": fusion_fp16["launches"]},
        "max_abs_err": fusion_fp16["max_abs_err"],  # against plain; bit-equal to the upcasts'
        **timed_fields(fusion_fp16),
        "library_ms": None,  # no single PyTorch call computes the fusion
        "shape": fusion_fp16["shape"],  # layer4; layer3 in the bf16 line
        "cluster_size": fusion_fp16["cluster_size"],
        "float32_kernel_ms": fusion_fp16["float32_kernel_ms"],
    }]}
    gemm = int8_sites["int8_gemm"]
    for name in ("quantize_gather", "dequant_epilogue"):
        t = int8_sites[name]
        kernel_line["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": "weaklysuperviseddl_tpu_torch/csrc/qconv.cu",
            # no TPU kernel: JAX's int8 convolution is XLA's (the rewrite binds it here)
            "replaces": "weaklysuperviseddl_tpu/ops/quant.py:414",
            **by_path(name, serve_int8=int8_launches[name]),
            "max_abs_err": t["max_abs_err"],  # every site against plain, bit-equal
            # one int8 forward at batch 64: the sum over its calls at their shapes
            "calls_per_forward": t["calls"],
            "ms": t["ms"],
            "device_ms": int8_breakdown[name],
            "host_ms": t["host_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": "bytes",
            "bytes": t["bytes"],
            "library_ms": None,  # no single PyTorch call gathers int8 patches or dequantizes
            **({"int8_gemm": {  # torch._int_mm (cuBLASLt), the library's product, not ours
                "calls_per_forward": gemm["calls"], "ms": gemm["ms"],
                "device_ms": int8_breakdown["int8_gemm"], "plain_ms": gemm["plain_ms"],
                "bound_ms": gemm["bound_ms"],  # each call's max(operations, bytes), summed
                "bound_by": ("operations" if gemm["ops"] / INT8_OPS_PER_S
                             > gemm["bytes"] / HBM_BYTES_PER_S else "bytes"),
                "ops": gemm["ops"], "bytes": gemm["bytes"],
                "launches": int8_launches["int8_gemm"]}} if name == "quantize_gather" else {}),
        })
    for row in kernel_line["kernels"]:  # no kernel lies on the foundation path
        row["launches_by_path"]["foundation"] = foundation_launches[row["name"]]
    emit("wall", seconds_by_phase=seconds, seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps(kernel_line), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
