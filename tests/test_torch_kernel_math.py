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
  JAX package's XLA labelling.
"""

import numpy as np
import pytest
import torch

from weaklysuperviseddl_tpu.masks.components import label_components as jax_label_components
from weaklysuperviseddl_tpu_torch.losses.window import affinity_exponent, window_offsets
from weaklysuperviseddl_tpu_torch.masks import synthetic
from weaklysuperviseddl_tpu_torch.ops.bilateral import EXP2_SCALE, gaussian_filter_plain_cross
from weaklysuperviseddl_tpu_torch.ops.cc import image_plan_bytes, plan_for
from weaklysuperviseddl_tpu_torch.ops.refine import TILE
from weaklysuperviseddl_tpu_torch.ops.window import window_sum_grad_plain


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
