"""The plain reference of int8 mask serving: the float DeepLabV3 of
``reference/models.py`` calibrated and run with every convolution in
integer arithmetic, as the configuration states the int8 program:

* weights per output channel, symmetric: scale amax/127 (1 where amax is 0),
  codes round-half-even(w/scale) clipped to ±127;
* activations per tensor, symmetric: scale max(amax/127, 1e-12), amax the
  largest |x| a site's input takes over the calibration images (observed in
  batches of ``max_batch``), codes round-half-even(x · float32(1/scale))
  clipped to ±127;
* the integer products summed exactly (float64 holds every sum of these
  sizes), then times float32(s_w · s_x), plus the bias;
* an ASPP branch's 3x3 convolution at rate r on an H x W map with 4·r ≥ min(H, W) is
  one 1x1 site per kernel tap that reaches inside the map, each with its own
  activation scale (the largest |x| of the region that tap reads), their
  outputs summed.

``bits`` sets the codes' range (2^(bits−1) − 1): 8 is the configuration, 4
the control. The float steps between sites follow the configuration's
arithmetic: an eval BatchNorm is (v − mean) · m + β with m = rsqrt(var +
eps) · γ computed once in float32, each step rounded once, and the ASPP's
global average is taken in float64 and rounded once. Masks are the argmax
of the logits, then the largest
8-connected component (ties to the component whose first pixel comes first
in raster order), found with ``scipy.ndimage.label``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.models import ASPP
from benchmark.reference.train import preprocess


def _codes(x: torch.Tensor, inv: float, top: int) -> torch.Tensor:
    inv32 = torch.tensor(np.float32(inv), dtype=torch.float32, device=x.device)
    return torch.round(x.float() * inv32).clamp_(-top, top)


def _weight_codes(w: torch.Tensor, top: int):
    """Per output channel (dim 0): (codes, scale [F]) in float32."""
    w = w.detach().float().cpu()
    amax = w.abs().amax(dim=tuple(range(1, w.ndim)))
    scale = torch.where(amax > 0, amax / float(top), torch.ones_like(amax))
    q = torch.clamp(torch.round(w / scale.view(-1, *[1] * (w.ndim - 1))), -top, top)
    return q, scale


def _taps(conv: nn.Conv2d, H: int, W: int):
    """The taps of an ASPP branch's tap plan at H x W (None: a plain
    dilated convolution): (iy, ix, dy, dx) of each tap reaching the map."""
    r = conv.dilation[0]
    if not getattr(conv, "aspp_branch", False) or 4 * r < min(H, W):
        return None
    return [(iy, ix, dy, dx) for iy, dy in enumerate((-r, 0, r)) if abs(dy) < H
            for ix, dx in enumerate((-r, 0, r)) if abs(dx) < W]


def _region(x, dy, dx):
    """(source slice of x, output rows, output cols) of one tap."""
    H, W = x.shape[-2:]
    oy, ox = slice(max(0, -dy), min(H, H - dy)), slice(max(0, -dx), min(W, W - dx))
    src = x[:, :, oy.start + dy:oy.stop + dy, ox.start + dx:ox.stop + dx]
    return src, oy, ox


class IntReference:
    """A float model's convolutions as integer sites: ``observe`` batches,
    then call it on normalised images for float32 logits."""

    def __init__(self, model: nn.Module, bits: int = 8):
        self.model = model.eval()
        self.top = 2 ** (bits - 1) - 1
        self.convs = {n: m for n, m in model.named_modules() if isinstance(m, nn.Conv2d)}
        self.amax: dict = {}
        for aspp in (m for m in model.modules() if isinstance(m, ASPP)):
            for m in aspp.modules():
                if isinstance(m, nn.Conv2d) and m.kernel_size == (3, 3):
                    m.aspp_branch = True

    def _sites(self, name, conv, x):
        """[(key, input region)] of the sites one call of ``conv`` makes."""
        taps = _taps(conv, *x.shape[-2:])
        if taps is None:
            return [(name, x)]
        return [((name, iy, ix), _region(x, dy, dx)[0]) for iy, ix, dy, dx in taps]

    @torch.no_grad()
    def observe(self, x: torch.Tensor):
        def pre(name):
            def hook(conv, args):
                for key, src in self._sites(name, conv, args[0]):
                    a = float(src.abs().amax())
                    self.amax[key] = max(self.amax.get(key, 0.0), a)
            return hook

        handles = [m.register_forward_pre_hook(pre(n)) for n, m in self.convs.items()]
        try:
            self.model(x)
        finally:
            for h in handles:
                h.remove()

    def _site(self, key, conv, src, w):
        """One site's float32 output: integer products, exact sums, rescale."""
        s_x = max(self.amax[key] / self.top, 1e-12)
        q_x = _codes(src, 1.0 / s_x, self.top).double()
        q_w, s_w = _weight_codes(w, self.top)
        rescale = (s_w * torch.tensor(np.float32(s_x))).to(src.device)
        return q_x, q_w.to(src.device).double(), rescale

    def _conv(self, name, conv):
        def forward(x):
            taps = _taps(conv, *x.shape[-2:])
            if taps is None:
                q_x, q_w, rescale = self._site(name, conv, x, conv.weight)
                acc = F.conv2d(q_x, q_w, None, conv.stride, conv.padding, conv.dilation)
                out = acc.float() * rescale.view(1, -1, 1, 1)
            else:
                out = x.new_zeros((x.shape[0], conv.out_channels, *x.shape[-2:]))
                for iy, ix, dy, dx in taps:
                    src, oy, ox = _region(x, dy, dx)
                    q_x, q_w, rescale = self._site((name, iy, ix), conv, src,
                                                   conv.weight[:, :, iy, ix])
                    acc = torch.einsum("bchw,fc->bfhw", q_x, q_w)
                    out[:, :, oy, ox] += acc.float() * rescale.view(1, -1, 1, 1)
            if conv.bias is not None:
                out = out + conv.bias.view(1, -1, 1, 1)
            return out
        return forward

    @staticmethod
    def _norm(bn: nn.BatchNorm2d):
        mean = bn.running_mean.detach().float().cpu()
        mul = torch.rsqrt(bn.running_var.detach().float().cpu() + bn.eps)
        mul = mul * bn.weight.detach().float().cpu()
        beta = bn.bias.detach().float().cpu()
        dev = bn.running_mean.device
        mean, mul, beta = (t.to(dev).view(1, -1, 1, 1) for t in (mean, mul, beta))
        return lambda v: (v - mean) * mul + beta

    @staticmethod
    def _mean(x):
        return x.double().mean(dim=(2, 3), keepdim=True).float()

    @torch.no_grad()
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        swapped = {m: self._conv(n, m) for n, m in self.convs.items()}
        for m in self.model.modules():
            if isinstance(m, nn.BatchNorm2d):
                swapped[m] = self._norm(m)
            elif isinstance(m, nn.AdaptiveAvgPool2d):
                swapped[m] = self._mean
        saved = {m: m.forward for m in swapped}
        for m, fn in swapped.items():
            m.forward = fn
        try:
            return self.model(x)
        finally:
            for m, fn in saved.items():
                m.forward = fn


def keep_largest(masks: np.ndarray) -> np.ndarray:
    """The largest 8-connected component of each [H,W] {0,1} mask."""
    from scipy import ndimage

    out = np.zeros_like(masks, dtype=np.uint8)
    structure = np.ones((3, 3), dtype=int)
    for i, m in enumerate(masks):
        labels, n = ndimage.label(m, structure=structure)
        if n:
            sizes = np.bincount(labels.ravel())[1:]
            out[i] = labels == 1 + int(np.argmax(sizes))
    return out


def calibrate(ref: IntReference, images_u8: torch.Tensor, size: int, batch: int):
    """Observe the calibration images in windows of ``batch`` (a ragged
    last window filled by tiling, as a serving program observes them)."""
    n = images_u8.shape[0]
    total = -(-n // batch) * batch
    idx = torch.arange(total, device=images_u8.device) % n
    for s in range(0, total, batch):
        ref.observe(preprocess(images_u8[idx[s:s + batch]], size))


def masks(ref: IntReference, images_u8: torch.Tensor, size: int, batch: int = 32) -> np.ndarray:
    """Served masks of ``images_u8``: argmax, then the largest component."""
    out = []
    for s in range(0, images_u8.shape[0], batch):
        logits = ref(preprocess(images_u8[s:s + batch], size))
        out.append(logits.argmax(dim=1).to(torch.uint8).cpu().numpy())
    return keep_largest(np.concatenate(out))
