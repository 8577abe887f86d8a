"""Operations, bytes and least times from shapes: the yardstick of every
roofline share and ``mfu`` the benchmark reports.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity), at its
700 W limit. A kernel's least time is the larger of its operations over the
peak rate and its bytes over HBM bandwidth; each input byte is counted read
once and each output byte written once, whatever the kernel reads again.

``refine_work``, ``window_pairs``, ``window_work``, ``bilateral_work``,
``cc_bound_ms``, ``roofline`` and ``conv_gflop`` are copies of the same
functions in ``chip_smoke.py``. ``conv_gflop`` here counts the taps that
land inside the input only (an ASPP branch at rate 36 on a 32² map spends
most of a dense convolution's products on padding) and also counts the
backward pass; the int8 model's sites are counted on the float model they
replace.

A roofline share takes its kernel time from the device trace alone. Where
the benchmark also times a kernel's calls with CUDA events (K3's), both
times are reported and ``times_part`` flags them where they part; a share
over 100% is reported as read, since it shows operations or bytes counted
too high or kernel time the trace leaves out.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
FP32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
INT8_OPS_PER_S = 1979e12    # H100 SXM int8 tensor cores, dense


def roofline(nbytes: float, ops: float, ops_per_s: float = FP32_OPS_PER_S):
    """(least ms, what binds it) over the card's HBM and compute rates."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def window_pairs(window: int) -> int:
    """Pixel pairs per pixel of the window terms: inside the image the terms
    (p, o) and (p + o, -o) share their affinity and their squared difference,
    and each pair's a·d enters the gradient at p and, negated, at p + o."""
    return (window * window - 1) // 2


def refine_work(B: int, H: int, W: int, C: int, window: int, steps: int, loss: str):
    """(bytes, fp32 operations) the refinement (K1) needs at the least.
    Bytes: S, the image and the int32 mask read once, the uint8 mask written
    once. Operations, each exp/log/div/sqrt counted as one, over the window
    pairs P and the classes the window term needs (one at C=2: t is a
    softmax, so d₁ = −d₀ and g₁ = −g₀):
      once per pixel: the P colour affinities (11 each) and S·log S (3 per class);
      per pixel and step: softmax(X) (5C-2) and, for ncut, softmax(q) (5C-2);
        KL (5 per class); per pair and class needed 6 (d, a·d, a·d·d into the
        sum, a·d into the gradient at both ends); the VJPs and the KL
        gradient (13 per class, +4 per class for ncut); Adam (14 per class)."""
    P = window_pairs(window)
    swept = 1 if C == 2 else C
    px = B * H * W
    softmaxes = (5 * C - 2) * (2 if loss == "ncut" else 1)
    per_step = (softmaxes + 5 * C + 6 * P * swept + (13 + (4 if loss == "ncut" else 0)) * C
                + 14 * C)
    ops = px * (11 * P + 3 * C + steps * per_step)
    nbytes = px * (4 * C + 4 * 3 + 4 + 1)
    return nbytes, ops


def window_work(B: int, H: int, W: int, C: int, window: int, backward: bool):
    """(bytes, fp32 operations) of the window sum (K4), or its gradient."""
    P = window_pairs(window)
    px = B * H * W
    ops = px * (11 * P + (4 if backward else 3) * P * C + (2 * C if backward else 0))
    nbytes = px * 4 * (C + 3 + (C if backward else 0))
    return nbytes, ops


def bilateral_work(B: int, Nq: int, Nk: int, d: int, C: int):
    """(bytes, fp32 operations) of one exact bilateral filter call (K3).
    Per key pair: d subtractions, d multiplies and d - 1 adds for the squared
    distance, the exp, and C multiply-adds (2 each)."""
    ops = B * Nq * Nk * (3 * d + 2 * C)
    nbytes = 4 * B * (Nq * d + Nk * d + Nk * C + Nq * C)
    return nbytes, ops


def cc_bound_ms(B: int, H: int, W: int) -> float:
    """Least time of the connected-components labelling (K2): one uint8 mask
    read and one int32 label written per pixel."""
    return B * H * W * (1 + 4) / HBM_BYTES_PER_S * 1e3


def q1_bytes(region_elems: int, Mp: int, Kp: int) -> int:
    """Bytes of one int8 gather call (Q1): the float32 input region it reads
    and the int8 [Mp, Kp] operand it writes."""
    return region_elems * 4 + Mp * Kp


def q2_bytes(B: int, H: int, W: int, N: int, accumulate: bool) -> int:
    """Bytes of one int8 epilogue call (Q2): the int32 accumulator read, the
    float32 output written, and the output read first where it accumulates."""
    return B * H * W * N * (4 + 4 + (4 if accumulate else 0))


def _in_bounds(out_n: int, in_n: int, k: int, stride: int, pad: int, dilation: int) -> list[int]:
    """For each kernel offset along one axis, the output positions whose
    source lies inside the input (the taps that land in the padding are
    products with zero and are not counted)."""
    return [sum(1 for o in range(out_n) if 0 <= o * stride - pad + i * dilation < in_n)
            for i in range(k)]


def conv_flops(B: int, cin_per_group: int, cout: int, in_hw, out_hw, kernel, stride,
               padding, dilation, backward: bool) -> float:
    """Operations of one convolution, 2 per multiply-add, over the taps that
    land inside the input: the forward, and with ``backward`` also the
    gradients of its input and of its weight, each as many as the forward."""
    rows = _in_bounds(out_hw[0], in_hw[0], kernel[0], stride[0], padding[0], dilation[0])
    cols = _in_bounds(out_hw[1], in_hw[1], kernel[1], stride[1], padding[1], dilation[1])
    fwd = 2.0 * B * cout * cin_per_group * sum(rows) * sum(cols)
    return fwd * (3 if backward else 1)


def conv_gflop(model, x, backward: bool = False, within: str = "") -> float:
    """GFLOP the model's ``nn.Conv2d`` modules need on ``x``, from the shapes
    that forward hooks see in one forward pass; ``backward``: a training
    step's forward and backward, less the input gradient of the first
    convolution, which nothing needs. ``within``: only the modules whose
    name starts with it."""
    import torch

    total = [0.0]
    seen = []

    def hook(m, inputs, out):
        inp = inputs[0]
        args = (inp.shape[0], m.in_channels // m.groups, m.out_channels, inp.shape[-2:],
                out.shape[-2:], m.kernel_size, m.stride, m.padding, m.dilation)
        flops = conv_flops(*args, backward=backward)
        if backward and not seen:
            flops -= conv_flops(*args, backward=False)
        seen.append(m)
        total[0] += flops

    handles = [m.register_forward_hook(hook) for name, m in model.named_modules()
               if isinstance(m, torch.nn.Conv2d) and name.startswith(within)]
    model.eval()
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in handles:
            h.remove()
    return total[0] / 1e9


PART_FACTOR = 1.5


def times_part(trace_ms: float | None, events_ms: float | None,
               factor: float = PART_FACTOR) -> bool:
    """Whether a kernel's trace time and its CUDA events' time part by more
    than ``factor`` either way (the events also hold launch gaps, so they
    read somewhat longer)."""
    if not trace_ms or not events_ms:
        return False
    return max(trace_ms, events_ms) > factor * min(trace_ms, events_ms)
