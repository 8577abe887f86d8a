"""int8 post-training quantization for serving (port of
weaklysuperviseddl_tpu/ops/quant.py).

The JAX package rewrites every weight conv and matmul of a traced jaxpr; the
port finds the same sites on the module tree and computes what JAX's rewrite
computes:

  * weights: per output channel symmetric int8 (``_quantize_weight``: scale
    amax/127, 1 where amax is 0, round half to even, clip ±127), taken once
    at ``build``;
  * activations: per tensor symmetric int8 with scale
    max(amax · clip_ratio / 127, 1e-12), amax the running absmax of the
    site's input over the calibration batches (``observe``);
  * int32 accumulation, then float32 ``acc · (s_w · s_x)`` (the product
    rounded to float32 first, as JAX's epilogue), then the op's bias.

Sites, in JAX's target order (the order the forward runs them): every
``nn.Conv2d`` with one group and every ``nn.Linear``, each of kind "conv" or
"dot" as JAX names its targets, with JAX's rhs shape as its fingerprint (HWIO
for a conv, [in, out] for a matmul). Two model-specific plans follow JAX's:

  * the ResNet stem (``models/resnet.StemConv``) is fingerprinted with the
    kernel JAX's ``s2d`` plan convolves with, [4, 4, 12, F] (the same integer
    products as the 7x7/2 convolution that runs here);
  * an ASPP atrous convolution (``models/deeplabv3.AtrousConv``) is, where
    JAX's ``4·rate ≥ min(H, W)`` rule picks its tap plan, one "dot" site a
    tap: its own [C, F] weight scales, its own activation scale (the absmax
    of that tap's source region), its contribution added into the output in
    JAX's order. DeepLabV3-ResNet50 at 256² has 77 sites (58 conv, 19 dot).

Each site runs as ``ops/qconv.py``'s Q1 gather, int32 GEMM and Q2 epilogue
(the CUDA kernels on the card). The eval BatchNorm that takes a site's output
(every BatchNorm of DeepLabV3 does) runs inside that site's epilogue, in
flax's order ((v − mean) · rsqrt(var + eps) · scale + bias, each step rounded
once), and the ASPP's global average is taken in float64 and rounded once
(``GlobalMean``). The float steps of the int8 program are then the same bits
on the card and on the CPU: ReLU, residual adds and pooling maxima are exact,
so a calibration serves the same masks on either (only the last resize's
sums can differ, in the logits' last bits). Without that, one activation
rounded to the other int8 level early in the network moves later activations
by about one int8 step, which re-rounds others: the two devices' masks drift
apart as far as int8 and float32 masks do. The resizes stay float, as in
JAX. The calibration file (``calibration_state``) is JAX's JSON key for key,
so either package loads the other's.

Used by ``pipelines/serve.Predictor.quantize``.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn

from weaklysuperviseddl_tpu_torch.models.deeplabv3 import AtrousConv, Tap, atrous_taps
from weaklysuperviseddl_tpu_torch.models.resnet import StemConv
from weaklysuperviseddl_tpu_torch.ops.qconv import (
    Geometry,
    dequant_epilogue,
    int8_gemm,
    padded,
    quantize_gather,
    quantize_plain,
)

CALIBRATION_VERSION = 1


def _quantize_weight(w: torch.Tensor, out_dim: int):
    """Per-output-channel symmetric int8. Returns (q [int8], scale [F] f32)."""
    w = w.float()
    reduce_dims = tuple(d for d in range(w.ndim) if d != out_dim)
    amax = w.abs().amax(dim=reduce_dims)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    shape = [1] * w.ndim
    shape[out_dim] = -1
    q = torch.clamp(torch.round(w / scale.reshape(shape)), -127, 127).to(torch.int8)
    return q, scale


def _quantize_act(x: torch.Tensor, scale: float) -> torch.Tensor:
    """``scale`` is the dequantization step (absmax/127): q = round(x/scale),
    as x times float32(1/scale)."""
    return quantize_plain(x, 1.0 / scale).to(torch.int8)


@dataclass(frozen=True)
class Site:
    """One quantized site: the module's path, JAX's kind and rhs shape, the
    input's shape at the traced batch (a tap's: its source region's), and
    the tap of an atrous convolution's tap plan."""

    name: str
    kind: str
    weight_shape: tuple
    lhs: tuple
    tap: Tap | None = None


def _is_site(m: nn.Module) -> bool:
    return isinstance(m, nn.Linear) or (isinstance(m, nn.Conv2d) and m.groups == 1)


def _tap_source(x: torch.Tensor, t: Tap) -> torch.Tensor:
    """The region of x [B,C,H,W] a tap reads."""
    return x[:, :, t.oy0 + t.dy:t.oy1 + t.dy, t.ox0 + t.dx:t.ox1 + t.dx]


def _module_sites(name: str, m: nn.Module, x: torch.Tensor) -> list[Site]:
    """The sites one call of ``m`` on ``x`` makes."""
    if isinstance(m, nn.Linear):
        return [Site(name, "dot", (m.in_features, m.out_features), tuple(x.shape))]
    H, W = x.shape[-2:]
    taps = m.taps(H, W) if isinstance(m, AtrousConv) else None
    if taps is not None:
        return [Site(name, "dot", (m.in_channels, m.out_channels),
                     tuple(_tap_source(x, t).shape), t) for t in taps]
    O, I, kh, kw = m.weight.shape
    shape = m.jax_kernel_shape(H, W) if isinstance(m, StemConv) else (kh, kw, I, O)
    return [Site(name, "conv", tuple(shape), tuple(x.shape))]


def _run_sites(model: nn.Module, x: torch.Tensor, visit) -> None:
    """One forward of ``model`` on ``x`` without gradients, calling
    ``visit(name, module, input)`` before every site module runs; a module
    that runs twice in a forward raises (its sites would be ambiguous)."""
    seen = set()

    def hook(name):
        def pre(module, args):
            if name in seen:
                raise ValueError(f"module {name!r} runs more than once in a forward; "
                                 "its quantized sites would be ambiguous")
            seen.add(name)
            visit(name, module, args[0])
        return pre

    handles = [m.register_forward_pre_hook(hook(name))
               for name, m in model.named_modules() if _is_site(m)]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in handles:
            h.remove()


def _fingerprint(sites: Sequence[Site]):
    return [(s.name, s.kind, s.weight_shape, s.tap) for s in sites]


@dataclass
class QuantReport:
    """What the pass did: one row per quantized site."""

    rows: list = field(default_factory=list)

    def __str__(self):
        lines = [f"{len(self.rows)} sites quantized to int8:"]
        for r in self.rows:
            lines.append(f"  [{r['site']:3d}] {r['kind']:4s} {r['name']} lhs{r['lhs']} "
                         f"rhs{r['rhs']} act_scale={r['act_scale']:.3e}")
        return "\n".join(lines)


class Int8Quantizer:
    """Three-phase PTQ of one model (eval mode, one input tensor).

    >>> q = Int8Quantizer(model, example_images)
    >>> for images in calibration_batches: q.observe(images)
    >>> qmodel, report = q.build()   # same call signature and outputs as model

    The sites are those of a forward at ``example_images``' shape; inputs of
    another batch size have the same sites, and an input whose size changes
    them (an atrous convolution switching plans) raises, as in JAX."""

    def __init__(self, model: nn.Module, example_images: torch.Tensor):
        self.model = model
        self._sites, self._norms = self._trace(example_images)
        self._amax = np.zeros(len(self._sites), np.float64)

    def _trace(self, x: torch.Tensor):
        """The sites of a forward at x's shape, from one image (a site's lhs
        carries x's batch size), and {site module: the eval BatchNorm module
        that takes its output}."""
        sites: list[Site] = []
        outputs, norms = {}, {}

        def keep_output(name):
            def hook(module, args, out):
                outputs[name] = out  # held, so that no later tensor reuses its id
            return hook

        def pair_norm(bn_name):
            def pre(module, args):
                for name, out in outputs.items():
                    if args[0] is out and not module.training and module.track_running_stats:
                        norms[name] = bn_name
            return pre

        named = list(self.model.named_modules())
        handles = ([m.register_forward_hook(keep_output(n)) for n, m in named if _is_site(m)]
                   + [m.register_forward_pre_hook(pair_norm(n)) for n, m in named
                      if isinstance(m, nn.BatchNorm2d)])
        try:
            _run_sites(self.model, x[:1],
                       lambda name, m, inp: sites.extend(_module_sites(name, m, inp)))
        finally:
            for h in handles:
                h.remove()
        return ([Site(s.name, s.kind, s.weight_shape, (x.shape[0],) + s.lhs[1:], s.tap)
                 for s in sites], norms)

    @property
    def num_targets(self) -> int:
        return len(self._sites)

    def _kinds_and_shapes(self):
        return ([s.kind for s in self._sites],
                [[int(d) for d in s.weight_shape] for s in self._sites])

    def calibration_state(self) -> dict:
        """The calibration as a portable JSON-able artifact, JAX's format:
        per-site activation absmax plus the structural fingerprint (kinds and
        weight shapes, batch-independent)."""
        kinds, wshapes = self._kinds_and_shapes()
        return {
            "version": CALIBRATION_VERSION,
            "n_targets": self.num_targets,
            "kinds": kinds,
            "weight_shapes": wshapes,
            "amax": [float(a) for a in self._amax],
        }

    def load_calibration(self, state: dict) -> None:
        """Adopt a ``calibration_state()`` artifact (written by either
        package) instead of observing batches. A fingerprint that does not
        match this model's sites raises."""
        kinds, wshapes = self._kinds_and_shapes()
        if state.get("version") != CALIBRATION_VERSION:
            raise ValueError(f"unknown calibration state version {state.get('version')!r}")
        if (state.get("n_targets") != self.num_targets or state.get("kinds") != kinds
                or state.get("weight_shapes") != wshapes):
            raise ValueError(
                "calibration state does not match this function's quantizable "
                f"graph: state has {state.get('n_targets')} targets "
                f"{state.get('kinds')} / weight shapes "
                f"{state.get('weight_shapes')}, function has "
                f"{self.num_targets} {kinds} / {wshapes}")
        amax = np.asarray(state.get("amax", ()), np.float64)
        if amax.shape != (self.num_targets,) or not np.all(np.isfinite(amax)) \
                or np.any(amax < 0):
            raise ValueError("calibration amax must be one finite non-negative value per target")
        if not amax.any():
            raise ValueError("calibration state is uncalibrated (all-zero amax)")
        self._amax = amax

    def observe(self, images: torch.Tensor) -> None:
        """Run one calibration batch; fold each site's input absmax into the
        running maxima."""
        sites, amax = [], []

        def visit(name, m, x):
            for s in _module_sites(name, m, x):
                sites.append(s)
                src = x if s.tap is None else _tap_source(x, s.tap)
                amax.append(src.abs().amax().float())

        _run_sites(self.model, images, visit)
        if _fingerprint(sites) != _fingerprint(self._sites):
            raise ValueError("input shape changes the set of quantizable equations — "
                             "calibrate and serve with structurally identical shapes")
        self._amax = np.maximum(self._amax, torch.stack(amax).double().cpu().numpy())

    def build(self, clip_ratio: float = 1.0):
        """Freeze the scales and return (qmodel, report): a copy of the model
        whose site modules run in int8 (``QuantizedConv``, ``QuantizedTaps``)
        with the BatchNorms they take in (each replaced by the identity),
        whose global average pools are ``GlobalMean``, and whose other
        modules are the float model's. ``clip_ratio`` scales the observed
        absmax."""
        if not self._sites:
            raise ValueError("no quantizable conv/dot equations found")
        if not self._amax.any():
            raise ValueError("no calibration data observed — call observe()")
        act_scale = [max(float(a) * clip_ratio / 127.0, 1e-12) for a in self._amax]

        by_module: dict[str, list[int]] = {}
        for k, s in enumerate(self._sites):
            by_module.setdefault(s.name, []).append(k)
        # the copy shares the site modules' parameters, which it then drops
        memo = {id(p): p for name in by_module
                for p in self.model.get_submodule(name).parameters()}
        qmodel = copy.deepcopy(self.model, memo).eval()
        for name, ks in by_module.items():
            float_module = self.model.get_submodule(name)
            norm = self._norms.get(name)
            folded = None if norm is None else _norm_constants(self.model.get_submodule(norm))
            if self._sites[ks[0]].tap is not None:
                q = QuantizedTaps(float_module, [self._sites[k].tap for k in ks],
                                  [act_scale[k] for k in ks], folded)
            else:
                q = QuantizedConv(float_module, act_scale[ks[0]], folded)
            _replace(qmodel, name, q)
            if norm is not None:
                _replace(qmodel, norm, nn.Identity())
        for name, m in self.model.named_modules():
            if isinstance(m, nn.AdaptiveAvgPool2d) and m.output_size in (1, (1, 1)):
                _replace(qmodel, name, GlobalMean())

        report = QuantReport()
        for k, s in enumerate(self._sites):
            report.rows.append({"site": k, "name": s.name, "kind": s.kind, "lhs": s.lhs,
                                "rhs": s.weight_shape, "act_scale": act_scale[k]})
        return qmodel, report


def _replace(model: nn.Module, name: str, module: nn.Module):
    parent, _, child = name.rpartition(".")
    setattr(model.get_submodule(parent) if parent else model, child, module)


def _norm_constants(bn: nn.BatchNorm2d) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """An eval BatchNorm as flax applies it, (x − mean) · mul + beta with
    mul = rsqrt(var + eps) · scale: (mean, mul, beta), float32, computed once
    on the CPU so that every device gets the same bits."""
    mean = bn.running_mean.detach().float().cpu()
    mul = torch.rsqrt(bn.running_var.detach().float().cpu() + bn.eps)
    beta = torch.zeros_like(mean)
    if bn.affine:
        mul = mul * bn.weight.detach().float().cpu()
        beta = bn.bias.detach().float().cpu()
    dev = bn.running_mean.device
    return mean.to(dev), mul.to(dev), beta.clone().to(dev)


class GlobalMean(nn.Module):
    """``nn.AdaptiveAvgPool2d(1)``'s function with the sum taken in float64
    and rounded to float32 once: the same bits on the card and the CPU
    (float32 sums in two orders differ in their last bits)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.double().mean(dim=(2, 3), keepdim=True).float()


def _site_weight(w: torch.Tensor, s_x: float, Np: int, Kp: int):
    """A site's [N, K] float weights → (int8 [Np, Kp] zero-padded, rescale
    [N] = s_w · s_x in float32, s_x rounded to float32 as JAX's epilogue
    takes it), computed on the CPU and moved to w's device: CUDA divides by
    a host scalar (amax / 127) as a multiply by its reciprocal, which would
    give other scales on the card than on the CPU and in JAX."""
    q, s_w = _quantize_weight(w.detach().cpu(), 0)
    out = torch.zeros((Np, Kp), dtype=torch.int8)
    out[:q.shape[0], :q.shape[1]] = q
    rescale = s_w * torch.tensor(np.float32(s_x))
    return out.to(w.device), rescale.to(w.device)


def _register_norm(module: nn.Module, norm):
    for key, t in zip(("norm_mean", "norm_mul", "norm_beta"), norm or (None,) * 3):
        module.register_buffer(key, t)


def _norm(module: nn.Module):
    return None if module.norm_mean is None else (module.norm_mean, module.norm_mul,
                                                  module.norm_beta)


class QuantizedConv(nn.Module):
    """A conv (or linear) site in int8: Q1 gather → int32 GEMM → Q2
    epilogue (+ the bias, then the BatchNorm ``norm`` = (mean, mul, beta) it
    takes in). Takes and returns what the float module (and its BatchNorm)
    does; a conv's output is NCHW in channels-last memory (the epilogue
    writes NHWC)."""

    def __init__(self, module: nn.Conv2d | nn.Linear, act_scale: float, norm=None):
        super().__init__()
        w = module.weight.detach()
        if isinstance(module, nn.Linear):
            self.linear = True
            self.geometry = (1, 1, 1, 0, 1)
            w2 = w
        else:
            self.linear = False
            kh, kw = module.kernel_size
            (sh, sw), (ph, pw), (dh, dw) = module.stride, module.padding, module.dilation
            if sh != sw or ph != pw or dh != dw or isinstance(module.padding, str):
                raise ValueError(f"quantized convs take square strides, paddings and "
                                 f"dilations, got {module}")
            self.geometry = (kh, kw, sh, ph, dh)
            w2 = w.permute(0, 2, 3, 1).reshape(w.shape[0], -1)   # columns (ky, kx, c)
        # an atrous conv's rate: at another input size it may switch to the tap plan
        self.rate = module.rate if isinstance(module, AtrousConv) else None
        self.N, self.K = w2.shape
        _, Kp, Np = padded(1, self.K, self.N)
        weight_q, rescale = _site_weight(w2, act_scale, Np, Kp)
        self.register_buffer("weight_q", weight_q)
        self.register_buffer("rescale", rescale)
        self.register_buffer("bias", None if module.bias is None
                             else module.bias.detach().float().clone())
        _register_norm(self, norm)
        self.inv = 1.0 / act_scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kh, kw, stride, pad, dil = self.geometry
        if self.linear:
            lead = x.shape[:-1]
            xh = x.reshape(-1, 1, 1, x.shape[-1]).float().contiguous()
            Ho = Wo = 1
        else:
            H, W = x.shape[-2:]
            if self.rate is not None and atrous_taps(self.rate, H, W) is not None:
                raise ValueError("input shape changes the set of quantizable equations — "
                                 "calibrate and serve with structurally identical shapes")
            xh = x.permute(0, 2, 3, 1).float().contiguous()
            Ho = (H + 2 * pad - dil * (kh - 1) - 1) // stride + 1
            Wo = (W + 2 * pad - dil * (kw - 1) - 1) // stride + 1
        B = xh.shape[0]
        Mp, Kp, _ = padded(B * Ho * Wo, self.K, self.N)
        a = quantize_gather(xh, self.inv, Geometry(kh, kw, stride, pad, dil, 0, 0, Ho, Wo),
                            Mp, Kp)
        acc = int8_gemm(a, self.weight_q)
        out = torch.empty((B, Ho, Wo, self.N), dtype=torch.float32, device=x.device)
        dequant_epilogue(acc, self.rescale, self.bias, out, Ho, Wo, norm=_norm(self))
        if self.linear:
            return out.reshape(*lead, self.N)
        return out.permute(0, 3, 1, 2)


class QuantizedTaps(nn.Module):
    """An atrous convolution in JAX's tap plan, in int8: per tap, its source
    region's Q1 gather, the int32 GEMM with its [C, F] weights, and the Q2
    epilogue adding its contribution into the output (zeros first), in
    JAX's order; the last tap's epilogue then applies the BatchNorm ``norm``
    it takes in."""

    def __init__(self, module: AtrousConv, taps: Sequence[Tap], act_scales: Sequence[float],
                 norm=None):
        super().__init__()
        self.rate = module.rate
        self.taps = list(taps)
        w = module.weight.detach()
        self.N, self.K = w.shape[0], w.shape[1]
        _, Kp, Np = padded(1, self.K, self.N)
        qs, rescales = zip(*(_site_weight(w[:, :, t.iy, t.ix], s_x, Np, Kp)
                             for t, s_x in zip(self.taps, act_scales)))
        self.register_buffer("weight_q", torch.stack(qs))
        self.register_buffer("rescale", torch.stack(rescales))
        _register_norm(self, norm)
        self.inv = [1.0 / s for s in act_scales]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, _, H, W = x.shape
        if atrous_taps(self.rate, H, W) != self.taps:
            raise ValueError("input shape changes the set of quantizable equations — "
                             "calibrate and serve with structurally identical shapes")
        xh = x.permute(0, 2, 3, 1).float().contiguous()
        out = torch.zeros((B, H, W, self.N), dtype=torch.float32, device=x.device)
        for i, t in enumerate(self.taps):
            h, w = t.oy1 - t.oy0, t.ox1 - t.ox0
            Mp, Kp, _ = padded(B * h * w, self.K, self.N)
            g = Geometry(1, 1, 1, 0, 1, t.oy0 + t.dy, t.ox0 + t.dx, h, w)
            acc = int8_gemm(quantize_gather(xh, self.inv[i], g, Mp, Kp), self.weight_q[i])
            last = i == len(self.taps) - 1
            dequant_epilogue(acc, self.rescale[i], None, out, h, w, t.oy0, t.ox0,
                             accumulate=True, norm=_norm(self) if last else None)
        return out.permute(0, 3, 1, 2)


def quantize_for_serving(model: nn.Module, calibration_batches: Sequence[torch.Tensor],
                         clip_ratio: float = 1.0):
    """One-call PTQ: calibrate ``model`` on the given input batches and
    return ``(qmodel, report)``."""
    if not calibration_batches:
        raise ValueError("need at least one calibration batch")
    q = Int8Quantizer(model, calibration_batches[0])
    for batch in calibration_batches:
        q.observe(batch)
    return q.build(clip_ratio=clip_ratio)
