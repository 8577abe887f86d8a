"""Sort-based permutohedral lattice: high-dimensional Gaussian filtering by
splat, blur and slice (port of weaklysuperviseddl_tpu/masks/permutohedral.py;
Adams et al. 2010, the filter behind pydensecrf's ``addPairwiseBilateral``
that the reference calls at AlternatingDirectionCutLoss.py:183-204).

The same construction as the JAX package, batched over images:

  * elevate the features onto the hyperplane H_d, find the nearest
    remainder-0 point and the rank differential (ties as the C++ loop breaks
    them), the barycentric weights and the d+1 simplex vertex keys;
  * the hash table is a sort: the M = N·(d+1) splat entries are sorted by
    their packed key, and equal-key runs are the lattice vertices. The d ≤ 5
    coordinates of 12 bits each pack into one int64, in the lexicographic
    order of JAX's three int32 keys, so one stable ``torch.sort`` replaces
    ``lax.sort(num_keys=3)``;
  * per-vertex splat sums are differences of a cumulative sum at run
    boundaries (no scatter-add), and the blur neighbours along the d+1
    lattice directions are found once per image by ``torch.searchsorted``
    over the sorted keys; slot M is a zero slot for missing neighbours.

The cumulative sum runs in float64: over M entries (301,056 at 224²) a
float32 sum loses its low bits to the running total before the run
boundaries are differenced, and how many depends on the order the device
sums in. JAX sums in float32 (a sequential window on the CPU), so it is the
port that is nearer the exact lattice.

The filter carries an arbitrary constant scale (the [1,2,1] blur is not
normalised), which the symmetric normalisation of ``masks/densecrf.py``
cancels. Features whose keys leave the packed range poison the splat weights
with NaN, so the output turns NaN instead of quietly wrong; the CRF checks
the range beforehand with ``coordinate_bound``.
"""

from __future__ import annotations

import math

import torch

_COORD_BITS = 12
_COORD_OFF = 1 << (_COORD_BITS - 1)   # 2048
_COORD_MAX = _COORD_OFF - 1           # 2047
MAX_DIMS = 64 // _COORD_BITS          # 5 coordinates fill one int64 key


def coordinate_bound(max_abs_features) -> int:
    """Static bound on the lattice coordinates' magnitude for features with
    per-dimension absolute bounds ``max_abs_features`` (d floats): elevated_i
    is a ±combination of the scaled features, and rounding to the nearest
    remainder-0 point and the wrap add at most 2·(d+1)."""
    d = len(max_abs_features)
    inv_std = math.sqrt(2.0 / 3.0) * (d + 1)
    bound = 0.0
    for i, mf in enumerate(max_abs_features):
        scale = inv_std / math.sqrt((i + 1) * (i + 2))
        bound += scale * (i + 1) * float(mf)
    return int(math.ceil(bound)) + 2 * (d + 1)


def _pack_keys(keys: torch.Tensor) -> torch.Tensor:
    """[..., d] integer lattice coordinates → [...] int64 keys, 12 bits a
    coordinate, the first coordinate most significant (clipped to the packed
    range, as JAX clips)."""
    shifted = (keys.long() + _COORD_OFF).clamp(0, 2 * _COORD_OFF - 1)
    d = keys.shape[-1]
    shifts = _COORD_BITS * torch.arange(d - 1, -1, -1, device=keys.device)
    return (shifted << shifts).sum(-1)  # the fields do not overlap: the sum is an or


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B,R,...] rows at idx [B,K] → [B,K,...]."""
    view = idx.view(*idx.shape, *([1] * (x.ndim - 2)))
    return torch.gather(x, 1, view.expand(*idx.shape, *x.shape[2:]))


def permutohedral_precompute(feats: torch.Tensor) -> dict:
    """The iteration-invariant lattice geometry of features [N,d] or
    [B,N,d] (d ≤ 5), as tensors ``permutohedral_filter`` takes. Each image
    has M = N·(d+1) entry slots and M + 1 vertex slots, slot M the zero slot
    for missing blur neighbours; ``n_vertices`` [B] counts the vertices."""
    if feats.ndim == 2:
        feats = feats[None]
    B, N, d = feats.shape
    if not 1 <= d <= MAX_DIMS:
        raise ValueError(f"the lattice packs 1..{MAX_DIMS} feature dimensions into one key, "
                         f"got {d}")
    dev = feats.device
    d1 = d + 1
    M = N * d1
    # exact divisions on every device (a CUDA division by a host scalar is a
    # reciprocal multiply)
    d1_t = torch.tensor(float(d1), dtype=torch.float32, device=dev)

    # elevate onto the hyperplane H_d; the suffix sums run from the last
    # coordinate down, in JAX's order
    inv_std = math.sqrt(2.0 / 3.0) * d1
    scale = torch.tensor([inv_std / math.sqrt((i + 1) * (i + 2)) for i in range(d)],
                         dtype=torch.float32, device=dev)
    cf = feats.float() * scale                                       # [B,N,d]
    suffix = [cf[..., d - 1]]
    for i in range(d - 2, -1, -1):
        suffix.append(suffix[-1] + cf[..., i])
    suffix = torch.stack(suffix[::-1], dim=-1)                       # Σ_{k≥i} cf_k
    j_idx = torch.arange(1, d1, dtype=torch.float32, device=dev)
    suffix_next = torch.cat([suffix[..., 1:], torch.zeros_like(suffix[..., :1])], dim=-1)
    elevated = torch.cat([suffix[..., :1], suffix_next[..., :d] - j_idx * cf], dim=-1)

    # nearest remainder-0 point
    v = elevated / d1_t
    up = torch.ceil(v) * d1_t
    down = torch.floor(v) * d1_t
    rem0 = torch.where(up - elevated < elevated - down, up, down)
    ssum = torch.round(rem0.sum(-1) / d1_t).to(torch.int64)

    # rank differential, ties as the C++ loop breaks them
    di = elevated - rem0
    less = di[..., :, None] < di[..., None, :]                       # di_i < di_j
    iu = torch.triu(torch.ones((d1, d1), dtype=torch.bool, device=dev), diagonal=1)
    rank = (less & iu).sum(-1) + ((~less) & iu).sum(-2) + ssum[..., None]
    rem0 = rem0.to(torch.int64)
    wrap = torch.where(rank < 0, d1, 0) - torch.where(rank > d, d1, 0)
    rank = rank + wrap
    rem0 = rem0 + wrap

    # barycentric weights from the wrapped rem0; each output slot takes at
    # most one + and one − term, so the sum is exact in any order
    vb = (elevated - rem0.float()) / d1_t                            # [B,N,d+1]
    slots = torch.arange(d + 2, device=dev)
    sign = ((d - rank)[..., None] == slots).float() - ((d1 - rank)[..., None] == slots).float()
    bary = (vb[..., None] * sign).sum(-2)                            # [B,N,d+2]
    bary[..., 0] += 1.0 + bary[..., d1]
    wt = bary[..., :d1]

    # simplex vertex keys, the first d coordinates
    r = torch.arange(d1, device=dev).view(1, 1, d1, 1)
    cond = rank[:, :, None, :d] <= d - r
    keys = rem0[:, :, None, :d] + r + torch.where(cond, 0, -d1)      # [B,N,d+1,d]
    keys_e = keys.reshape(B, M, d)
    wt_e = wt.reshape(B, M)
    overflow = keys_e.abs().amax(dim=(1, 2)) > _COORD_MAX            # [B]
    wt_e = torch.where(overflow[:, None], torch.full_like(wt_e, float("nan")), wt_e)
    packed = _pack_keys(keys_e)                                      # [B,M]

    # sort the entries by key; equal-key runs are the lattice vertices
    sorted_keys, e = torch.sort(packed, dim=1, stable=True)
    is_start = torch.ones((B, M), dtype=torch.bool, device=dev)
    is_start[:, 1:] = sorted_keys[:, 1:] != sorted_keys[:, :-1]
    vid = torch.cumsum(is_start, dim=1) - 1                          # [B,M] run id
    is_end = torch.ones_like(is_start)
    is_end[:, :-1] = is_start[:, 1:]
    idx = torch.arange(M, device=dev).expand(B, M)
    # run boundaries to vertex slots; every other entry lands in the dump slot M
    start_tgt = torch.where(is_start, vid, M)
    end_tgt = torch.where(is_end, vid, M)
    start_idx = torch.zeros((B, M + 1), dtype=torch.int64, device=dev).scatter_(
        1, start_tgt, idx)[:, :M]
    end_plus = torch.zeros((B, M + 1), dtype=torch.int64, device=dev).scatter_(
        1, end_tgt, idx + 1)[:, :M]
    # each vertex's coordinates (zero in the slots past the last vertex)
    keys_sorted = _gather_rows(keys_e, e)                            # [B,M,d]
    vkeys = torch.zeros((B, M + 1, d), dtype=torch.int64, device=dev).scatter_(
        1, start_tgt[..., None].expand(B, M, d), keys_sorted)[:, :M]

    # blur neighbours: ±1 along each of the d+1 lattice directions
    eye = torch.eye(d, dtype=torch.int64, device=dev)
    blur_n1, blur_n2 = [], []
    for axis in range(d1):
        off_p = 1 - d1 * eye[axis] if axis < d else torch.ones(d, dtype=torch.int64, device=dev)
        for off, out in ((off_p, blur_n1), (-off_p, blur_n2)):
            q = _pack_keys(vkeys + off)
            pos = torch.searchsorted(sorted_keys, q)
            pos_c = pos.clamp(max=M - 1)
            found = (pos < M) & (torch.gather(sorted_keys, 1, pos_c) == q)
            out.append(torch.where(found, torch.gather(vid, 1, pos_c), M))

    return {
        "d1": d1, "M": M,
        "pix_sorted": torch.div(e, d1, rounding_mode="floor"),     # entry → pixel
        "wt_sorted": torch.gather(wt_e, 1, e),
        "start_idx": start_idx,
        "end_plus": end_plus,
        "blur_n1": torch.stack(blur_n1),                            # [d+1,B,M]
        "blur_n2": torch.stack(blur_n2),
        "vslot": torch.zeros((B, M), dtype=torch.int64, device=dev).scatter_(1, e, vid),
        "wt": wt_e,
        "n_vertices": vid[:, -1] + 1,
    }


def permutohedral_filter(values: torch.Tensor, pre: dict) -> torch.Tensor:
    """Gaussian-filter ``values`` [N,C] (or [B,N,C]) through the precomputed
    lattice: s·K(values) for a constant s, to be paired with symmetric
    normalisation."""
    single = values.ndim == 2
    if single:
        values = values[None]
    B, N, C = values.shape
    d1, M = pre["d1"], pre["M"]

    # splat: per-vertex sums as float64 cumsum differences at run boundaries,
    # scanned along the innermost dimension ([B,C,M]: CUDA's scan over an
    # outer dimension of [B,M,C] is an order of magnitude slower)
    contrib = (_gather_rows(values, pre["pix_sorted"]) * pre["wt_sorted"][..., None])
    cs = torch.cumsum(contrib.transpose(1, 2).contiguous(), dim=2, dtype=torch.float64)
    cs = torch.nn.functional.pad(cs, (1, 0))                         # [B,C,M+1]
    ends = pre["end_plus"][:, None, :].expand(B, C, M)
    starts = pre["start_idx"][:, None, :].expand(B, C, M)
    vval = (torch.gather(cs, 2, ends) - torch.gather(cs, 2, starts)).float().transpose(1, 2)

    # blur [1,2,1] along each lattice direction; slot M stays zero
    zero_row = torch.zeros((B, 1, C), dtype=values.dtype, device=values.device)
    vals = torch.cat([vval, zero_row], dim=1)                        # [B,M+1,C]
    for axis in range(d1):
        n1 = _gather_rows(vals, pre["blur_n1"][axis])
        n2 = _gather_rows(vals, pre["blur_n2"][axis])
        vals = torch.cat([2.0 * vals[:, :M] + n1 + n2, zero_row], dim=1)

    # slice
    out = _gather_rows(vals, pre["vslot"]) * pre["wt"][..., None]    # [B,M,C]
    out = out.reshape(B, N, d1, C).sum(dim=2)
    return out[0] if single else out
