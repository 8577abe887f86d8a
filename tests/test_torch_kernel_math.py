"""The arithmetic the port's CUDA kernels rely on, checked on the CPU in
float64 with the plain versions (the kernels themselves run only on the card):

* the refinement's window pass (``csrc/refine.cu``) takes, at pixels more
  than pad from every image edge, the gradient of the window sum as
  4·Σ_o aff_o(u)·d_o(u) instead of the gather over the reflect fold's
  preimages (the card's tests hold the kernel's own count of the pixels it
  sends through that gather to the same pad + 1 rule);
* the bilateral filter (``csrc/bilateral.cu``) scales the features by
  ``EXP2_SCALE`` and takes each weight as 2^(−‖s·fq − s·fk‖²);
* the connected-components kernel's image plan (``csrc/cc.cu``) labels 2x2
  pixel blocks, links them by the four patterns of its neighbour nodes,
  skips the links its neighbours already imply, and labels each component by
  the smallest first pixel of its nodes: a numpy model of that, held to the
  JAX package's XLA labelling;
* the window-sum kernel (``csrc/window.cu``'s forward) stages each tile over
  a halo that holds reflect's values, keeps one affinity per pair of
  positions and takes every pixel's whole sum from the centre role: a numpy
  model of that tiling and of the pair table's indexing, held to the plain
  window sum;
* the LayerCAM fusion (``csrc/cam_fusion.cu``) splits an image's channels
  over a cluster of S CTAs, sums the slices in rank order, and takes the
  min and max across the cluster: a numpy model of that split, held to the
  JAX package's Pallas kernel in interpret mode.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weaklysuperviseddl_tpu.masks.components import label_components as jax_label_components
from weaklysuperviseddl_tpu.ops.pallas_cam import fused_cam_fusion
from weaklysuperviseddl_tpu_torch.losses.window import affinity_exponent, window_offsets
from weaklysuperviseddl_tpu_torch.masks import synthetic
from weaklysuperviseddl_tpu_torch.ops.bilateral import EXP2_SCALE, gaussian_filter_plain_cross
from weaklysuperviseddl_tpu_torch.ops.cam_fusion import cluster_size
from weaklysuperviseddl_tpu_torch.ops.cc import image_plan_bytes, plan_for
from weaklysuperviseddl_tpu_torch.ops.refine import TILE
from weaklysuperviseddl_tpu_torch.ops.window import window_sum_grad_plain, window_sum_plain


def _edge_distance(H, W):
    """[H, W]: each pixel's distance to the nearest image edge (0 on the
    border)."""
    ys, xs = torch.arange(H)[:, None], torch.arange(W)[None, :]
    return torch.minimum(torch.minimum(ys, H - 1 - ys), torch.minimum(xs, W - 1 - xs))


def _clear_tiles(H, W, pad):
    """bool [tiles_y, tiles_x]: the TILE × TILE tiles that lie inside the
    image with every pixel pad + 1 or more from each edge."""
    dist = _edge_distance(H, W)
    out = torch.zeros((-(-H // TILE), -(-W // TILE)), dtype=torch.bool)
    for ty, tx in np.ndindex(*out.shape):
        block = dist[ty * TILE:(ty + 1) * TILE, tx * TILE:(tx + 1) * TILE]
        out[ty, tx] = block.shape == (TILE, TILE) and int(block.min()) >= pad + 1
    return out


def _centre_sum(probs, images, sigma_color, sigma_space, window_size):
    """Σ_o aff_o(u)·d_o(u), d_o(u) = p(u) − p(reflect(u + o)), in the dtype
    of the inputs: the centre role of the window gradient alone."""
    B, H, W, C = probs.shape
    pad = window_size // 2
    p_pad = torch.nn.functional.pad(probs.permute(0, 3, 1, 2), (pad,) * 4, mode="reflect")
    i_pad = torch.nn.functional.pad(images.permute(0, 3, 1, 2), (pad,) * 4, mode="reflect")
    centre_p = p_pad[:, :, pad:pad + H, pad:pad + W]
    centre_i = i_pad[:, :, pad:pad + H, pad:pad + W]
    total = torch.zeros_like(centre_p)
    for dy, dx in window_offsets(window_size):
        sl = (slice(None), slice(None), slice(pad + dy, pad + dy + H), slice(pad + dx, pad + dx + W))
        color = ((centre_i - i_pad[sl]) ** 2).sum(dim=1)
        aff = torch.exp(affinity_exponent(color, dy, dx, sigma_color, sigma_space))
        total = total + aff[:, None] * (centre_p - p_pad[sl])
    return total.permute(0, 2, 3, 1)


@pytest.mark.parametrize("C,normalised", [(2, True), (1, False), (3, True), (3, False),
                                          (5, False)])
@pytest.mark.parametrize("sigma_space", [None, 5.0])
@pytest.mark.parametrize("window", [3, 5, 7])
def test_interior_gradient_is_four_times_the_centre_sum(window, sigma_space, C, normalised):
    """float64 at [1,40,44,C]: within 1e-12 wherever a pixel is pad + 1 or
    more from every edge (so on every pixel of a tile clear of the edges),
    and off by far more on pixels exactly pad from an edge, where reflect adds
    a preimage: the kernel must send those through the gather. It holds per
    class, for any C and for probs that do not sum to 1 (the window-loss
    gradient kernel takes raw logits from the ncut loss's callers)."""
    rng = np.random.default_rng(window + (0 if sigma_space is None else 1) + 10 * C)
    H, W, pad = 40, 44, window // 2
    probs = torch.from_numpy(rng.uniform(0, 1, (1, H, W, C)))
    if normalised:
        probs = probs / probs.sum(-1, keepdim=True)
    else:
        probs = 4.0 * probs - 2.0
    images = torch.from_numpy(rng.uniform(-1, 1, (1, H, W, 3)))
    grad = window_sum_grad_plain(probs, images, 0.5, sigma_space, window)[0]
    fast = 4.0 * _centre_sum(probs, images, 0.5, sigma_space, window)[0]
    err = (grad - fast).abs().amax(dim=-1)
    edge = _edge_distance(H, W)
    assert float(err[edge >= pad + 1].max()) <= 1e-12
    assert float(err[edge == pad].max()) > 1e-3
    tiles = _clear_tiles(H, W, pad)
    assert bool(tiles.any())
    for ty, tx in tiles.nonzero().tolist():
        block = err[ty * TILE:(ty + 1) * TILE, tx * TILE:(tx + 1) * TILE]
        assert float(block.max()) <= 1e-12


@pytest.mark.parametrize("window,shape,share", [(5, (256, 256), 196 / 256), (3, (256, 256), 196 / 256),
                                                (7, (96, 100), 20 / 42)])
def test_interior_tile_share(window, shape, share):
    """196 of the 256 tiles of a 256² image (14 of 16 per side) are clear of
    the edges at windows 3 to 7 (the first tile starts at 0, the last ends at
    the edge); the pixels within pad of an edge are the frame of width
    pad + 1. These are the shares the card's smoke run reads from the
    kernel's own count of its edge phase's pixels."""
    H, W, pad = *shape, window // 2
    assert float(_clear_tiles(H, W, pad).float().mean()) == pytest.approx(share)
    rim = 2 * (pad + 1)
    assert float((_edge_distance(H, W) <= pad).float().mean()) == pytest.approx(
        1 - (H - rim) * (W - rim) / (H * W))


def _reference_features(size, seed):
    """CRF bilateral features at the reference's σ (position / 50, colour / 5:
    ‖f‖² up to about 7e3) and values, float64."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (size, size, 3)).astype(np.float64)
    yy, xx = np.mgrid[0:size, 0:size] / 50.0
    feats = np.stack([xx, yy] + [img[..., c] / 5.0 for c in range(3)], -1).reshape(-1, 5)
    return feats, rng


@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("size,seed", [(24, 0), (32, 1), (20, 2)])
def test_exp2_weights_at_reference_magnitudes(size, seed, C):
    """Features scaled by s = √(½·log₂e), weights 2^(−Σ(s·Δ)²): in float64
    the same filter as exp(−½‖Δ‖²) (1e-12). With the kernel's float32 steps
    (s rounded to float, the scaled features and their differences rounded,
    the sum in float32) within 1e-5 of the float64 filter and of the plain
    float32 version, relative to the largest output: the scaled differences
    carry one more rounding (about 2e-6 at these sizes, against the plain
    version's 7e-7), ten times inside the 1e-4 the kernel is held to."""
    feats, rng = _reference_features(size, seed)
    values = rng.uniform(0, 1, (size * size, C))
    d2 = ((feats[:, None, :] - feats[None, :, :]) ** 2).sum(-1)
    gold = np.exp(-0.5 * d2) @ values
    scaled = feats * EXP2_SCALE
    exp2 = np.exp2(-((scaled[:, None, :] - scaled[None, :, :]) ** 2).sum(-1)) @ values
    np.testing.assert_allclose(exp2, gold, rtol=1e-12, atol=1e-14)

    s32 = (feats.astype(np.float32) * np.float32(EXP2_SCALE)).astype(np.float32)
    diff = s32[:, None, :] - s32[None, :, :]
    e32 = -(diff * diff).sum(-1, dtype=np.float32)
    kernel_like = np.exp2(e32.astype(np.float64)) @ values.astype(np.float32).astype(np.float64)
    peak = np.abs(gold).max()
    err = np.abs(kernel_like - gold).max() / peak
    plain = gaussian_filter_plain_cross(torch.from_numpy(feats.astype(np.float32)),
                                        torch.from_numpy(feats.astype(np.float32)),
                                        torch.from_numpy(values.astype(np.float32))).numpy()
    assert err <= 1e-5
    assert np.abs(kernel_like - plain).max() / peak <= 1e-5


def _node_patterns(mask):
    """[H, W] → [ceil(H/2), ceil(W/2)] ints: bit 0, 1, 2, 3 set where pixel
    (2i, 2j), (2i, 2j+1), (2i+1, 2j), (2i+1, 2j+1) is foreground (pixels past
    the edge are background)."""
    H, W = mask.shape
    m = np.zeros((H + H % 2, W + W % 2), np.int64)
    m[:H, :W] = mask != 0
    return m[0::2, 0::2] | m[0::2, 1::2] << 1 | m[1::2, 0::2] << 2 | m[1::2, 1::2] << 3


def _offers(row, j):
    """Whether node j of a node row offers its first pixel for its root's
    label, as the kernel decides: a node with a pixel in the top row whose
    west neighbour in the run has none, or a run's first node without one."""
    p = row[j]
    west = j > 0 and bool(p & 5 and row[j - 1] & 10)
    if p & 3:
        return not (west and row[j - 1] & 3)
    return bool(p) and not west


def block_labels(mask):
    """The image plan of ``csrc/cc.cu`` in numpy: union-find over 2x2 nodes
    with the kernel's links and skips, each component labelled by the
    smallest first foreground pixel of the nodes that offer theirs. (The
    kernel joins west-linked nodes as runs under their first node and unites
    the runs' heads, hooking roots by a hash of their position: the same
    sets.) Returns int32 labels, -1 for background."""
    H, W = mask.shape
    pat = _node_patterns(mask)
    rows, R = pat.shape
    parent = np.arange(rows * R)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def unite(a, b):
        a, b = find(a), find(b)
        parent[max(a, b)] = min(a, b)

    for i, j in np.ndindex(rows, R):
        n, p = i * R + j, pat[i, j]
        if not p:
            continue
        q = pat[i, j - 1] if j > 0 else 0
        west = bool(p & 5 and q & 10)
        if west:
            unite(n, n - 1)
        if i == 0:
            continue
        up, a = n - R, pat[i - 1, j]
        aw = pat[i - 1, j - 1] if j > 0 else 0
        ae = pat[i - 1, j + 1] if j + 1 < R else 0
        joined_w = west and q & 3 and aw & 12
        if p & 1 and aw & 8 and not joined_w:
            unite(n, up - 1)
        joined_w = joined_w or (p & 1 and aw & 8)
        joined = (west and q & 2 and a & 4) or (joined_w and a & 5 and aw & 10)
        if p & 3 and a & 12 and not joined:
            unite(n, up)
        joined = joined or (p & 3 and a & 12)
        if p & 2 and ae & 4 and not (joined and ae & 5 and a & 10):
            unite(n, up + 1)

    root_label = {}
    for i, j in np.ndindex(rows, R):
        p = pat[i, j]
        if p and _offers(pat[i], j):
            top = bool(p & 3)
            bits = p if top else p >> 2
            first = (2 * i + (0 if top else 1)) * W + 2 * j + (0 if bits & 1 else 1)
            r = find(i * R + j)
            root_label[r] = min(root_label.get(r, first), first)
    out = np.full((H, W), -1, np.int32)
    for y, x in zip(*np.nonzero(mask)):
        out[y, x] = root_label[find((y // 2) * R + x // 2)]
    return out


@pytest.mark.parametrize("shape", [(33, 17), (24, 40), (31, 33), (1, 9), (9, 1), (20, 130)])
@pytest.mark.parametrize("name", synthetic.FAMILIES)
def test_block_labelling_equals_jax(name, shape):
    """Every family (both masks of the paired ones) at odd and thin shapes,
    and node rows of more than one 32-node word (20x130): the 2x2-node
    labelling gives the JAX package's labels exactly (its fixed point run to
    the end)."""
    masks = synthetic.family(name, 2, shape, seed=5)
    for mask in masks:
        want = np.asarray(jax_label_components(mask, max_iters=mask.size))
        np.testing.assert_array_equal(block_labels(mask), want)


def test_block_labelling_takes_the_smallest_pixel_not_node():
    """Node 0 holds only pixel (1,0), index 8, but its component's smallest
    pixel is (0,5) in node 2: the label is 5, as the JAX package gives."""
    mask = np.zeros((4, 8), np.uint8)
    for y, x in ((1, 0), (2, 1), (2, 2), (2, 3), (1, 4), (0, 5)):
        mask[y, x] = 1
    got = block_labels(mask)
    assert set(got[mask == 1].tolist()) == {5}
    np.testing.assert_array_equal(got, np.asarray(jax_label_components(mask)))


@pytest.mark.parametrize("shape,plan", [((256, 256), "image"), ((224, 224), "image"),
                                        ((432, 432), "image"), ((1, 40000), "image"),
                                        ((434, 434), "tiles"), ((512, 512), "tiles")])
def test_cc_plan_by_shape(shape, plan):
    """The image plan takes an int32 a 2x2 node (and one every 32 of
    padding), five bit planes and 8 KB of link buffers (84 KB at 256²) and is
    chosen while that fits one block's 227 KB of shared memory."""
    assert plan_for(*shape) == plan
    assert image_plan_bytes(256, 256) == 4 * (16384 + 512) + 5 * 4 * 128 * 4 + 8192


def _reflect_reach(z, n):
    """window_common.cuh::reflect_reach: the pixel a halo position holds, -1
    past reflect's reach."""
    if z < -(n - 1) or z > 2 * (n - 1):
        return -1
    return -z if z < 0 else (2 * (n - 1) - z if z >= n else z)


def tiled_window_sum(probs, images, sigma_color, sigma_space, window):
    """window.cu's forward in numpy: per TILE x TILE tile, the image and
    probs over a halo of pad pixels that holds reflect's values (zeros past
    its reach), fill_pairs' table of one affinity per pair of positions
    (never-written entries NaN, so a read of one shows), and every pixel
    inside the image summing its window through PairAffinity's indexing
    (aff_o(u) for o after the centre, the pair (u + o, u) before it)."""
    B, H, W, C = probs.shape
    pad, win = window // 2, window
    K = win * win - 1
    half = K // 2
    offsets = [(m // win - pad, m % win - pad) for m in range(win * win) if m != K // 2]
    inv2sc = 1.0 / (2.0 * sigma_color ** 2)

    def spatial(dy, dx):
        return 0.0 if sigma_space is None else (dy * dy + dx * dx) / (2.0 * sigma_space ** 2)

    hs, rows, cols = TILE + 2 * pad, TILE + pad, TILE + 2 * pad
    total = 0.0
    for b, ty0, tx0 in np.ndindex(B, -(-H // TILE), -(-W // TILE)):
        ty0, tx0 = ty0 * TILE, tx0 * TILE
        ys = [_reflect_reach(ty0 - pad + i, H) for i in range(hs)]
        xs = [_reflect_reach(tx0 - pad + j, W) for j in range(hs)]
        img, t = np.zeros((hs, hs, 3)), np.zeros((hs, hs, C))
        for i, j in np.ndindex(hs, hs):
            if ys[i] >= 0 and xs[j] >= 0:
                img[i, j], t[i, j] = images[b, ys[i], xs[j]], probs[b, ys[i], xs[j]]
        pairs = np.full((half, rows, cols), np.nan)
        for h in range(half):
            dy, dx = offsets[half + h]
            for ry, rx in np.ndindex(rows, cols):
                py, px = ry - pad, rx - pad
                ny, nx = py + dy, px + dx
                if (py >= 0 and 0 <= px < TILE) or (0 <= ny < TILE and 0 <= nx < TILE):
                    cd = ((img[ry, rx] - img[ry + dy, rx + dx]) ** 2).sum()
                    pairs[h, ry, rx] = np.exp(-cd * inv2sc - spatial(dy, dx))
        for uy, ux in np.ndindex(TILE, TILE):
            if ty0 + uy >= H or tx0 + ux >= W:
                continue
            sy, sx = uy + pad, ux + pad
            for k, (dy, dx) in enumerate(offsets):
                if k >= half:
                    a = pairs[k - half, uy + pad, ux + pad]
                else:
                    a = pairs[K - 1 - k - half, uy + dy + pad, ux + dx + pad]
                d = t[sy, sx] - t[sy + dy, sx + dx]
                total += a * (d * d).sum()
    return total


@pytest.mark.parametrize("H,W,C", [(11, 13, 1), (9, 32, 2), (40, 35, 5), (64, 64, 6),
                                   (40, 35, 3), (11, 13, 4)])
@pytest.mark.parametrize("sigma_space", [None, 5.0])
@pytest.mark.parametrize("window", [3, 5, 7])
def test_tiled_pair_table_window_sum_equals_plain(window, sigma_space, H, W, C):
    """float64: the forward kernel's tiling, reflect-valued halo and pair
    table give the plain window sum within 1e-12 relative, edges and tiny
    images included (11x13 and 9x32 have no pixel more than pad from every
    edge at window 7, and halos that reach past reflect's range), for probs
    that do not sum to 1; no unwritten table entry is read."""
    rng = np.random.default_rng(window * 100 + H * W + C + (sigma_space is None))
    probs = rng.uniform(-1, 2, (1, H, W, C))
    images = rng.uniform(0, 1, (1, H, W, 3))
    got = tiled_window_sum(probs, images, 0.3, sigma_space, window)
    want = float(window_sum_plain(torch.from_numpy(probs), torch.from_numpy(images), 0.3,
                                  sigma_space, window))
    assert np.isfinite(got)
    assert got == pytest.approx(want, rel=1e-12)


CAM_THREADS = 512  # cam_fusion.cu's block


def cluster_cam_fusion(act, grad, S):
    """cam_fusion.cu in numpy (float64): per image, CTA r of the cluster sums
    the channels [r·CS, (r+1)·CS), CS = ceil(C/S), in G channel groups whose
    sums are added in group order; then CTA r takes the r-th share of the
    pixels, adds the S partials in rank order and applies the relu; the
    image's min and max are the CTAs' minima and maxima combined. Also
    counts how often each channel is read and each pixel written (each
    must be once). act, grad [B,C,h,w]."""
    B, C, h, w = act.shape
    hw = h * w
    vec = 4 if hw % 4 == 0 else 1
    CS = -(-C // S)
    PT = min(CAM_THREADS, hw // vec)
    G = max(1, min(CAM_THREADS // PT, CS))
    share = -(-hw // S)
    out = np.full((B, hw), np.nan)
    reads, writes = np.zeros((B, C), int), np.zeros((B, hw), int)
    prod = np.maximum(act.reshape(B, C, hw) * grad.reshape(B, C, hw), 0.0)
    for b in range(B):
        partial = np.zeros((S, hw))
        for r in range(S):
            groups = np.zeros((G, hw))
            for g in range(G):
                for c in range(r * CS + g, min(C, (r + 1) * CS), G):
                    groups[g] += prod[b, c]
                    reads[b, c] += 1
            partial[r] = groups.sum(0)
        cam, lows, highs = np.zeros(hw), [], []
        for r in range(S):
            p0 = min(hw, r * share)
            p1 = min(hw, p0 + share)
            mine = np.maximum(partial[:, p0:p1].sum(0), 0.0)
            cam[p0:p1] = mine
            lows.append(mine.min() if p1 > p0 else np.inf)
            highs.append(mine.max() if p1 > p0 else -np.inf)
        lo, hi = min(lows), max(highs)
        for r in range(S):
            p0 = min(hw, r * share)
            p1 = min(hw, p0 + share)
            out[b, p0:p1] = (cam[p0:p1] - lo) / (hi - lo + 1e-8)
            writes[b, p0:p1] += 1
    return out.reshape(B, h, w), reads, writes


@functools.lru_cache(maxsize=8)
def _cam_case(C, h, w):
    """Inputs [2,C,h,w] (float32, seeded) and the JAX package's Pallas
    kernel on them in interpret mode (it takes NHWC)."""
    rng = np.random.default_rng(C + h * w)
    act, grad = (rng.standard_normal((2, C, h, w)).astype(np.float32) for _ in range(2))
    want = fused_cam_fusion(jnp.asarray(act.transpose(0, 2, 3, 1)),
                            jnp.asarray(grad.transpose(0, 2, 3, 1)), interpret=True)
    return act, grad, np.asarray(want)


@pytest.mark.parametrize("h,w", [(7, 9), (14, 14)])
@pytest.mark.parametrize("C", [1, 130, 1024])
@pytest.mark.parametrize("S", [1, 2, 4, 8])
def test_cluster_split_cam_fusion_equals_jax(S, C, h, w):
    """The split over S CTAs, summed in rank order with the cluster-wide min
    and max, reads every channel once, writes every pixel once, equals the
    unsplit fusion in float64 within 1e-12, and the TPU kernel in interpret
    mode within 1e-5, the kernel's tolerance (the TPU kernel's float32 sums
    of 1024 channels are 1.3e-6 off float64). h·w = 63 takes the scalar
    loads, 196 the float4 ones; at C = 1 and S > 1 most CTAs have no
    channel."""
    act, grad, want = _cam_case(C, h, w)
    a64, g64 = act.astype(np.float64), grad.astype(np.float64)
    got, reads, writes = cluster_cam_fusion(a64, g64, S)
    assert (reads == 1).all() and (writes == 1).all()
    cam = np.maximum(np.maximum(a64 * g64, 0.0).sum(1), 0.0)
    cam -= cam.min(axis=(1, 2), keepdims=True)
    whole = cam / (cam.max(axis=(1, 2), keepdims=True) + 1e-8)
    np.testing.assert_allclose(got, whole, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("B,C,sms,S", [(32, 2048, 132, 4), (32, 1024, 132, 4), (40, 1024, 132, 4),
                                       (1, 130, 132, 8), (2, 130, 132, 8), (64, 2048, 132, 2),
                                       (200, 2048, 132, 1), (1, 1, 132, 1), (1, 3, 132, 2),
                                       (32, 2048, 114, 4)])
def test_cluster_size_fills_about_one_wave(B, C, sms, S):
    """The wrapper's choice of CTAs an image: B·S nearest to one wave of the
    card's SMs (132 on the H100 SXM, 114 on the PCIe card), a power of two
    up to the portable 8, never more than the channels."""
    assert cluster_size(B, C, sms) == S
