"""Dense-CRF mean-field inference on the device (port of
weaklysuperviseddl_tpu/masks/densecrf.py; ref the pydensecrf call in
AlternatingDirectionCutLoss.py:183-204: 2-label CRF, unary from [1−cam, cam],
Gaussian sxy 1 / compat 2 + bilateral sxy 50 / srgb 5 / compat 10, 5
mean-field iterations, argmax).

The same message passing as the JAX package: symmetric kernel normalisation
k'(x,y) = k(x,y)/√(n(x)n(y)) with the norms n = K·1 computed once, messages
m = K'Q including the pixel itself, Potts update Q ← softmax(−U + Σ_k w_k·m_k).

  * Gaussian (small σ_xy): the exact truncated separable convolution,
    radius max(1, int(3σ)), zero padding.
  * Bilateral, over the features [x/sxy, y/sxy, r/srgb, g/srgb, b/srgb]:
      - "attention": the exact O(N²) filter (``ops/bilateral.py``: the CUDA
        kernel on the card, the plain version on the CPU);
      - "subsampled" (the config's default): full-resolution queries against
        the stride-``key_stride`` subgrid of keys and values, through the same
        exact filter. The uniform 1/stride² quadrature scale cancels in the
        symmetric normalisation, since the norms use the same operator.
    Each filter call is one kernel launch for the whole batch.

Unlike the JAX package off the TPU, which sends H·W > 64² to its bilateral
grid, the port computes the exact filter at every size. The grid, lattice
and RFF backends are not ported yet (ROADMAP M9) and raise.
"""

from __future__ import annotations

import torch

from weaklysuperviseddl_tpu_torch.ops.bilateral import gaussian_filter_cross

EXACT_BACKENDS = ("attention", "subsampled")
LATER_BACKENDS = ("grid", "lattice", "rff")


def _gaussian_filter(values: torch.Tensor, sxy: float) -> torch.Tensor:
    """Truncated separable spatial Gaussian, σ = sxy, zero padding; values
    [B,H,W,C], filtered along H then W."""
    radius = max(1, int(3 * sxy))
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=values.device)
    k = torch.exp(-0.5 * (x / sxy) ** 2)

    def conv1d(v, dim):
        n = v.shape[dim]
        pad = [0, 0] * (v.ndim - 1 - dim) + [radius, radius]
        vp = torch.nn.functional.pad(v, pad)
        out = torch.zeros_like(v)
        for i in range(2 * radius + 1):
            out = out + k[i] * vp.narrow(dim, i, n)
        return out

    return conv1d(conv1d(values, 1), 2)


def _inv_sqrt_norm(filter_fn, shape, device) -> torch.Tensor:
    """1/√(K·1), [B,H,W,1]: constant across mean-field iterations, computed once."""
    n = filter_fn(torch.ones(shape, dtype=torch.float32, device=device))
    return torch.rsqrt(n.clamp(min=1e-20))


def _sym_message(filter_fn, Q: torch.Tensor, inv_sqrt: torch.Tensor) -> torch.Tensor:
    """Symmetric-normalised message m = (1/√n)·K(Q/√n)."""
    return filter_fn(Q * inv_sqrt) * inv_sqrt


def _bilateral_features(images: torch.Tensor, sxy: float, srgb: float) -> torch.Tensor:
    """[B,H,W,3] colours in [0,255] → [B,H,W,5] features [x/sxy, y/sxy, r/srgb,
    g/srgb, b/srgb]."""
    B, H, W, _ = images.shape
    dev = images.device
    yy = (torch.arange(H, dtype=torch.float32, device=dev) / sxy).view(1, H, 1, 1)
    xx = (torch.arange(W, dtype=torch.float32, device=dev) / sxy).view(1, 1, W, 1)
    return torch.cat([xx.expand(B, H, W, 1), yy.expand(B, H, W, 1), images / srgb], dim=-1)


def densecrf_inference(probs: torch.Tensor, images: torch.Tensor, gauss_sxy: float = 1.0,
                       gauss_compat: float = 2.0, bilat_sxy: float = 50.0,
                       bilat_srgb: float = 5.0, bilat_compat: float = 10.0, n_iters: int = 5,
                       bilat_backend: str = "attention", key_stride: int = 2) -> torch.Tensor:
    """Mean-field marginals [B,H,W,L] from initial label probabilities probs
    [B,H,W,L] and images [B,H,W,3] (uint8 or float in [0,255]), on the
    tensors' device. ``bilat_backend="subsampled"`` filters full-resolution
    queries against the stride-``key_stride`` key subgrid."""
    if bilat_backend in LATER_BACKENDS:
        raise NotImplementedError(f"bilat_backend={bilat_backend!r} is not ported yet "
                                  "(ROADMAP M9: the grid, lattice and RFF backends)")
    if bilat_backend not in EXACT_BACKENDS:
        raise ValueError(f"unknown bilat_backend {bilat_backend!r}")
    if key_stride < 1:
        raise ValueError(f"key_stride must be >= 1, got {key_stride}")
    images = images.float()
    probs = probs.float()
    B, H, W, L = probs.shape
    unary = -torch.log(probs.clamp(1e-8, 1.0))

    def gauss(v):
        return _gaussian_filter(v, gauss_sxy)

    feats_q = feats_k = None
    if bilat_compat:
        feats_hw = _bilateral_features(images, bilat_sxy, bilat_srgb)
        feats_q = feats_hw.reshape(B, H * W, 5)
        feats_k = (feats_hw[:, ::key_stride, ::key_stride].reshape(B, -1, 5)
                   if bilat_backend == "subsampled" else feats_q)

    def bilat(v):
        C = v.shape[-1]
        if bilat_backend == "subsampled":
            vk = v[:, ::key_stride, ::key_stride].reshape(B, -1, C)
        else:
            vk = v.reshape(B, H * W, C)
        return gaussian_filter_cross(feats_q, feats_k, vk).reshape(B, H, W, C)

    gauss_inv = _inv_sqrt_norm(gauss, (B, H, W, 1), probs.device) if gauss_compat else None
    bilat_inv = _inv_sqrt_norm(bilat, (B, H, W, 1), probs.device) if bilat_compat else None

    Q = torch.softmax(-unary, dim=-1)
    for _ in range(n_iters):
        logits = -unary
        if gauss_compat:
            logits = logits + gauss_compat * _sym_message(gauss, Q, gauss_inv)
        if bilat_compat:
            logits = logits + bilat_compat * _sym_message(bilat, Q, bilat_inv)
        Q = torch.softmax(logits, dim=-1)
    return Q


def apply_dense_crf(images: torch.Tensor, cams: torch.Tensor, n_iters: int = 5,
                    **kwargs) -> torch.Tensor:
    """The reference's surface (AlternatingDirectionCutLoss.py:183-204): cams
    [B,H,W] in [0,1] → binary masks [B,H,W] uint8 through a 2-label CRF with
    unary softmax([1−cam, cam]). Images in [0,1] are taken to [0,255]: the
    test is on the max over the whole batch, as in the JAX package."""
    probs = torch.stack([1.0 - cams, cams], dim=-1).clamp(1e-8, 1.0)
    images = images.float()
    images = torch.where(images.max() <= 1.5, images * 255.0, images)
    Q = densecrf_inference(probs, images, n_iters=n_iters, **kwargs)
    return Q.argmax(dim=-1).to(torch.uint8)
