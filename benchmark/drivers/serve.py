"""Mask serving through ``Predictor.predict_many``: uint8 photos in, packed
binary masks of the largest component out (``pipelines/serve.py``).

Set-up makes the model's weights from the seed, centres the class-1 bias on
the reference's float logits (random weights put nearly every pixel in one
class), builds ``Predictor(clean=True, packed=True, max_batch=...)``,
quantizes it to int8 on the seeded calibration pets where the cell asks for
int8 (``Predictor.quantize``, the CLI's default serving program), draws the
pool of seeded pet photos and serves it once as the warm-up. A unit of the window
is one ``predict_many`` call over the pool.

``check`` compares a seeded sample of the photos served in each call with
the plain reference (``reference/serve.py``), which calibrates and quantizes
its own copy of the float model: the share of their mask pixels that differ.
"""

from __future__ import annotations

import dataclasses
import gc

import numpy as np
import torch

from benchmark import models

RATE = "serve_img_per_s"


@dataclasses.dataclass
class State:
    predictor: object
    pool: np.ndarray
    sample: dict                    # (call, row) → the served mask
    rng: np.random.Generator


def weights_and_bias(run):
    """The seed's weights with the class-1 bias moved by the reference's
    median logit margin on the calibration pets."""
    from benchmark.inputs import make_weights
    from benchmark.reference.train import preprocess

    cfg_m, dev = run.config, run.device
    weights = make_weights(models.reference_model(cfg_m), run.seed, dev)
    ref = models.reference_model(cfg_m, "meta").to_empty(device=dev)
    ref.load_state_dict(weights)
    ref.eval()
    cal = calibration_pets(run)
    with torch.no_grad():
        logits = torch.cat([ref(preprocess(cal[s:s + 16], cfg_m["image_size"]))
                            for s in range(0, cal.shape[0], 16)])
        margin = float((logits[:, 1] - logits[:, 0]).median())
    key = "classifier.4.bias"
    weights[key] = weights[key].clone()
    weights[key][1] -= margin
    return weights, cal


def calibration_pets(run) -> torch.Tensor:
    from benchmark.inputs import pets

    p = run.params
    images, _, _ = pets(p["calibration_images"], p["height"], p["width"], run.seed + 2,
                        run.device)
    return images


def setup(run):
    from weaklysuperviseddl_tpu_torch.pipelines.serve import Predictor

    from benchmark.inputs import pets

    p, cfg_m, dev = run.params, run.config, run.device
    models.set_precision(cfg_m)
    weights, cal = weights_and_bias(run)
    model = models.program_model(cfg_m, weights, dev).eval()
    del weights
    pred = Predictor(model, size=cfg_m["image_size"], max_batch=p["max_batch"], clean=True,
                     packed=True, device=dev)
    if p["int8"]:
        pred.quantize(cal.cpu().numpy())
    pool, _, _ = pets(p["photos"], p["height"], p["width"], run.seed + 3, dev)
    pool = pool.cpu().numpy()
    pred.predict_many(pool)        # every kernel, the batch shape, the pinned host buffers
    if run.trace:
        _span_dispatch(pred, run)
        if p["int8"]:
            run.extra.update(_site_bytes(pred, pool[:p["max_batch"]]))
    run.extra.update(batches_per_call=-(-p["photos"] // p["max_batch"]))
    return State(pred, pool, {}, np.random.default_rng(run.seed))


def _site_bytes(pred, images: np.ndarray) -> dict:
    """Bytes of every Q1 and Q2 call of one int8 forward at the batch shape
    (``counts.q1_bytes``, ``counts.q2_bytes``), from the calls' shapes."""
    from weaklysuperviseddl_tpu_torch.ops import quant
    from weaklysuperviseddl_tpu_torch.pipelines.serve import model_inputs

    from benchmark import counts

    real = quant.quantize_gather, quant.dequant_epilogue
    q1, q2 = [], []

    def gather(xh, inv, g, Mp, Kp):
        region = (xh[:, g.y0:g.y0 + g.Ho, g.x0:g.x0 + g.Wo] if g.kh == 1 and g.stride == 1
                  else xh)
        q1.append(counts.q1_bytes(region.numel(), Mp, Kp))
        return real[0](xh, inv, g, Mp, Kp)

    def epilogue(acc, rescale, bias, out, h, w, oy0=0, ox0=0, accumulate=False, norm=None):
        q2.append(counts.q2_bytes(out.shape[0], h, w, out.shape[3], accumulate))
        return real[1](acc, rescale, bias, out, h, w, oy0, ox0, accumulate, norm)

    quant.quantize_gather, quant.dequant_epilogue = gather, epilogue
    try:
        with torch.inference_mode():
            pred.quantized(model_inputs(torch.from_numpy(images).to(pred.device), pred.size))
    finally:
        quant.quantize_gather, quant.dequant_epilogue = real
    return {"q1_calls": len(q1), "q1_bytes": sum(q1), "q2_calls": len(q2), "q2_bytes": sum(q2)}


def _span_dispatch(pred, run):
    """The benchmark's spans around the predictor's dispatch and readback
    (its own methods, wrapped on this instance)."""
    dispatch, readback = pred.dispatch_async, pred.readback

    def dispatch_async(images):
        with run.spans("dispatch"):
            return dispatch(images)

    def wait(pending, n):
        with run.spans("readback"):
            return readback(pending, n)

    pred.dispatch_async, pred.readback = dispatch_async, wait


def unit(state: State, run, index: int) -> float:
    from weaklysuperviseddl_tpu_torch.ops import qconv
    from weaklysuperviseddl_tpu_torch.ops.cc import label_components_cuda

    p = run.params
    counted = (qconv.quantize_gather, qconv.dequant_epilogue, label_components_cuda)
    before = [f.launches for f in counted]
    with run.spans("call"):
        out = state.predictor.predict_many(state.pool)
    rows = state.rng.choice(len(state.pool), size=p["check_per_call"], replace=False)
    for r in rows:
        state.sample[(index, int(r))] = out[r].copy()
    if run.traced_unit == index:
        run.extra["traced_launches"] = {f.__name__: f.launches - b
                                        for f, b in zip(counted, before)}
    return float(len(state.pool))


def mismatch_share(served: np.ndarray, want: np.ndarray) -> float:
    return float((served != want).mean())


LIMIT_MODES = ("control",)


def limit_readings(run, mode: str) -> dict:
    """The control: the reference at 4 bits (float32: with TF32 on), put in
    the program's place."""
    from benchmark.inputs import pets

    p = run.params
    pool, _, _ = pets(p["photos"], p["height"], p["width"], run.seed + 3, run.device)
    rows = np.sort(np.random.default_rng(run.seed).choice(
        p["photos"], size=p["check_per_call"] * 4, replace=False))
    images = pool[torch.from_numpy(rows).to(run.device)]
    want = reference_masks(run, images, bits=8)
    got = reference_masks(run, images, bits=4, tf32=True)
    return {"mask_mismatch_share": mismatch_share(got, want)}


def reference_masks(run, images: torch.Tensor, bits: int, tf32: bool = False) -> np.ndarray:
    """The reference's served masks: int8 (``bits``) where the cell serves
    int8, else float32 (with TF32 where ``tf32``)."""
    from benchmark.reference.serve import IntReference, calibrate, masks
    from benchmark.reference.train import precision

    p, cfg_m, dev = run.params, run.config, run.device
    weights, cal = weights_and_bias(run)
    model = models.reference_model(cfg_m, "meta").to_empty(device=dev)
    model.load_state_dict(weights)
    model.eval()
    with torch.no_grad(), precision(tf32 and not p["int8"]):
        if not p["int8"]:
            from benchmark.reference.serve import keep_largest
            from benchmark.reference.train import preprocess

            out = [model(preprocess(images[s:s + 32], cfg_m["image_size"])).argmax(1)
                   for s in range(0, images.shape[0], 32)]
            return keep_largest(torch.cat(out).to(torch.uint8).cpu().numpy())
        ref = IntReference(model, bits)
        calibrate(ref, cal, cfg_m["image_size"], p["max_batch"])
        return masks(ref, images, cfg_m["image_size"])


def check(state: State, run) -> list:
    keys = sorted(state.sample)
    served = np.stack([state.sample[k] for k in keys])
    photos = sorted({r for _, r in keys})
    images_np = state.pool[photos]
    state.predictor = state.pool = None
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    images = torch.from_numpy(images_np).to(run.device)
    want = dict(zip(photos, reference_masks(run, images, bits=8)))
    share = mismatch_share(served, np.stack([want[r] for _, r in keys]))
    return [("mask_mismatch_share", share, run.limits["mask_mismatch_share"])]
