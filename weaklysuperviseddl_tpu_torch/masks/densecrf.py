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
  * Bilateral, over the features [x/sxy, y/sxy, r/srgb, g/srgb, b/srgb]
    (each filter carries its own constant scale, which the symmetric
    normalisation cancels):
      - "attention": the exact O(N²) filter (``ops/bilateral.py``: the CUDA
        kernel on the card, the plain version on the CPU);
      - "subsampled" (the config's default): full-resolution queries against
        the stride-``key_stride`` subgrid of keys and values, through the same
        exact filter. The uniform 1/stride² quadrature scale cancels in the
        symmetric normalisation, since the norms use the same operator.
        Each exact filter call is one kernel launch for the whole batch;
      - "grid": the bilateral grid (Chen et al.): a multilinear splat of each
        pixel into the 32 corners of its cell of a 5-D grid of σ-sized cells
        (+1 margin), a [1,2,1] blur along each axis (circular, as JAX's
        ``roll``), a multilinear slice. The splat is ``index_add_``, which
        on CUDA adds in an order that changes between launches;
      - "lattice": the permutohedral lattice (``masks/permutohedral.py``),
        the reference's own filter; its 12-bit keys must hold the
        coordinates, which is checked from the parameters and raises;
      - "rff": random Fourier features K ≈ ΦΦᵀ (``ops/bilateral.rff_basis``),
        two skinny products a filter; a measured negative result at the
        reference's bandwidths, kept as JAX keeps it.
    The grid and the lattice run the whole batch at once; RFF loops over the
    images (Φ is 411 MB an image at 224² and D 4096).

Unlike the JAX package off the TPU, which sends "attention" and
"subsampled" at H·W > 64² to its grid, the port computes the exact filter
at every size (K3 on the card); ``bilat_backend="grid"`` computes what JAX
computes there.
"""

from __future__ import annotations

import torch

from weaklysuperviseddl_tpu_torch.masks.permutohedral import (
    _COORD_MAX,
    coordinate_bound,
    permutohedral_filter,
    permutohedral_precompute,
)
from weaklysuperviseddl_tpu_torch.ops.bilateral import (
    gaussian_filter_cross,
    gaussian_filter_rff,
    rff_basis,
)
from weaklysuperviseddl_tpu_torch.utils.profiling import span

BACKENDS = ("attention", "subsampled", "grid", "lattice", "rff")
GRID_CORNERS = 32  # 2^5 corners of a cell of the 5-D grid


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


def _div(x: torch.Tensor, s: float) -> torch.Tensor:
    """x / s as an IEEE division on every device: CUDA divides by a host
    scalar as a multiply by its reciprocal, one ulp off the CPU's quotient
    for about a quarter of the values, which would move the grid's cells
    and the lattice's simplices between the card and the CPU."""
    return x / torch.tensor(s, dtype=x.dtype, device=x.device)


def _bilateral_features(images: torch.Tensor, sxy: float, srgb: float) -> torch.Tensor:
    """[B,H,W,3] colours in [0,255] → [B,H,W,5] features [x/sxy, y/sxy, r/srgb,
    g/srgb, b/srgb]."""
    B, H, W, _ = images.shape
    dev = images.device
    yy = _div(torch.arange(H, dtype=torch.float32, device=dev), sxy).view(1, H, 1, 1)
    xx = _div(torch.arange(W, dtype=torch.float32, device=dev), sxy).view(1, 1, W, 1)
    return torch.cat([xx.expand(B, H, W, 1), yy.expand(B, H, W, 1), _div(images, srgb)], dim=-1)


def _bilateral_precompute(images: torch.Tensor, sxy: float, srgb: float) -> dict:
    """The grid's iteration-invariant splat and slice geometry for images
    [B,H,W,3] in [0,255]: each pixel's 32 corner cells (flat indices into the
    batch's grids, image b's grid at offset b·total) and multilinear weights,
    [32,B·N], in a 5-D grid of σ-sized cells with a margin of 1."""
    B, H, W, _ = images.shape
    dev = images.device
    fy = (_div(torch.arange(H, dtype=torch.float32, device=dev), sxy) + 1.0).view(1, H, 1)
    fx = (_div(torch.arange(W, dtype=torch.float32, device=dev), sxy) + 1.0).view(1, 1, W)
    fc = _div(images, srgb) + 1.0
    feats = torch.stack([fy.expand(B, H, W), fx.expand(B, H, W),
                         fc[..., 0], fc[..., 1], fc[..., 2]], dim=-1)
    sizes = (int((H - 1) // sxy) + 3, int((W - 1) // sxy) + 3,
             int(255.0 // srgb) + 3, int(255.0 // srgb) + 3, int(255.0 // srgb) + 3)
    strides = [1] * 5
    for d in range(3, -1, -1):
        strides[d] = strides[d + 1] * sizes[d + 1]
    total = strides[0] * sizes[0]

    flat = feats.reshape(B, H * W, 5)
    lo = torch.floor(flat).to(torch.int64)
    frac = flat - lo
    offset = (torch.arange(B, device=dev) * total).view(B, 1)
    idxs, ws = [], []
    for corner in range(GRID_CORNERS):
        idx = offset
        w = torch.ones_like(frac[..., 0])
        for d in range(5):
            bit = (corner >> d) & 1
            idx = idx + (lo[..., d] + bit) * strides[d]
            w = w * (frac[..., d] if bit else 1.0 - frac[..., d])
        idxs.append(idx.reshape(-1))
        ws.append(w.reshape(-1))
    return {"idx": torch.stack(idxs), "w": torch.stack(ws), "sizes": sizes, "total": total}


def _bilateral_grid_filter(values: torch.Tensor, pre: dict) -> torch.Tensor:
    """The bilateral-grid filter of values [B,H,W,C]: s·K(values) for a
    constant s. The splat is one ``index_add_`` over the 32 corners in
    JAX's order (corner by corner, pixels in order), the blur circular."""
    B, H, W, C = values.shape
    vals = values.reshape(B * H * W, C)
    grid = torch.zeros((B * pre["total"], C), dtype=torch.float32, device=values.device)
    grid.index_add_(0, pre["idx"].reshape(-1),
                    (vals[None] * pre["w"][..., None]).reshape(-1, C))
    g = grid.view(B, *pre["sizes"], C)
    for d in range(1, 6):
        g = 2.0 * g + torch.roll(g, 1, dims=d) + torch.roll(g, -1, dims=d)
    grid = g.reshape(B * pre["total"], C)
    out = torch.zeros_like(vals)
    for corner in range(GRID_CORNERS):
        out = out + grid[pre["idx"][corner]] * pre["w"][corner][:, None]
    return out.reshape(B, H, W, C)


def densecrf_inference(probs: torch.Tensor, images: torch.Tensor, gauss_sxy: float = 1.0,
                       gauss_compat: float = 2.0, bilat_sxy: float = 50.0,
                       bilat_srgb: float = 5.0, bilat_compat: float = 10.0, n_iters: int = 5,
                       bilat_backend: str = "attention", rff_dim: int = 4096,
                       key_stride: int = 2) -> torch.Tensor:
    """Mean-field marginals [B,H,W,L] from initial label probabilities probs
    [B,H,W,L] and images [B,H,W,3] (uint8 or float in [0,255]), on the
    tensors' device. ``bilat_backend="subsampled"`` filters full-resolution
    queries against the stride-``key_stride`` key subgrid; ``rff_dim`` is
    RFF's number of features."""
    if bilat_backend not in BACKENDS:
        raise ValueError(f"unknown bilat_backend {bilat_backend!r}")
    if key_stride < 1:
        raise ValueError(f"key_stride must be >= 1, got {key_stride}")
    B, H, W, L = probs.shape
    if bilat_backend == "lattice" and bilat_compat:
        # the coordinates at these sizes and sigmas must fit the 12-bit keys
        bound = coordinate_bound([(W - 1) / bilat_sxy, (H - 1) / bilat_sxy]
                                 + [255.0 / bilat_srgb] * 3)
        if bound > _COORD_MAX:
            raise ValueError(f"lattice coordinates may exceed the packed-key range (bound "
                             f"{bound} > {_COORD_MAX}); use bilat_backend='grid' or larger "
                             "sigmas")
    kwargs = dict(gauss_sxy=gauss_sxy, gauss_compat=gauss_compat, bilat_sxy=bilat_sxy,
                  bilat_srgb=bilat_srgb, bilat_compat=bilat_compat, n_iters=n_iters,
                  bilat_backend=bilat_backend, rff_dim=rff_dim, key_stride=key_stride)
    if bilat_backend == "rff" and bilat_compat and B > 1:
        # Φ is N·D bfloat16 an image (411 MB at 224², D 4096): image by image
        return torch.cat([densecrf_inference(probs[b:b + 1], images[b:b + 1], **kwargs)
                          for b in range(B)])
    images = images.float()
    probs = probs.float()
    unary = -torch.log(probs.clamp(1e-8, 1.0))

    def gauss(v):
        return _gaussian_filter(v, gauss_sxy)

    bilat = None
    if bilat_compat and bilat_backend == "grid":
        grid = _bilateral_precompute(images, bilat_sxy, bilat_srgb)

        def bilat(v):
            return _bilateral_grid_filter(v, grid)
    elif bilat_compat:
        feats_hw = _bilateral_features(images, bilat_sxy, bilat_srgb)
        feats = feats_hw.reshape(B, H * W, 5)
        if bilat_backend == "lattice":
            lattice = permutohedral_precompute(feats)

            def bilat(v):
                return permutohedral_filter(v.reshape(B, H * W, -1), lattice).reshape(v.shape)
        elif bilat_backend == "rff":
            # bfloat16 values held as float32 once, not upcast at every call
            phi = rff_basis(feats[0], dim=rff_dim).float()

            def bilat(v):
                return gaussian_filter_rff(phi, v.reshape(H * W, -1)).reshape(v.shape)
        else:
            feats_k = (feats_hw[:, ::key_stride, ::key_stride].reshape(B, -1, 5)
                       if bilat_backend == "subsampled" else feats)

            def bilat(v):
                C = v.shape[-1]
                if bilat_backend == "subsampled":
                    vk = v[:, ::key_stride, ::key_stride].reshape(B, -1, C)
                else:
                    vk = v.reshape(B, H * W, C)
                return gaussian_filter_cross(feats, feats_k, vk).reshape(B, H, W, C)

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
    test is on the max over the whole batch, as in the JAX package. A
    ``crf`` span (``utils/profiling.span``) with ``iters``."""
    with span("crf", iters=n_iters):
        probs = torch.stack([1.0 - cams, cams], dim=-1).clamp(1e-8, 1.0)
        images = images.float()
        images = torch.where(images.max() <= 1.5, images * 255.0, images)
        Q = densecrf_inference(probs, images, n_iters=n_iters, **kwargs)
        return Q.argmax(dim=-1).to(torch.uint8)
