"""The arithmetic the port's CUDA kernels rely on, checked on the CPU in
float64 with the plain versions (the kernels themselves run only on the card):

* the refinement's window pass (``csrc/refine.cu``) takes, at pixels more
  than pad from every image edge, the gradient of the window sum as
  4·Σ_o aff_o(u)·d_o(u) instead of the gather over the reflect fold's
  preimages (the card's tests hold the kernel's own count of the pixels it
  sends through that gather to the same pad + 1 rule);
* the bilateral filter (``csrc/bilateral.cu``) scales the features by
  ``EXP2_SCALE`` and takes each weight as 2^(−‖s·fq − s·fk‖²).
"""

import numpy as np
import pytest
import torch

from weaklysuperviseddl_tpu_torch.losses.window import affinity_exponent, window_offsets
from weaklysuperviseddl_tpu_torch.ops.bilateral import EXP2_SCALE, gaussian_filter_plain_cross
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


@pytest.mark.parametrize("sigma_space", [None, 5.0])
@pytest.mark.parametrize("window", [3, 5, 7])
def test_interior_gradient_is_four_times_the_centre_sum(window, sigma_space):
    """float64 at [1,40,44,2]: within 1e-12 wherever a pixel is pad + 1 or
    more from every edge (so on every pixel of a tile clear of the edges),
    and off by far more on pixels exactly pad from an edge, where reflect adds
    a preimage: the kernel must send those through the gather."""
    rng = np.random.default_rng(window + (0 if sigma_space is None else 1))
    H, W, pad = 40, 44, window // 2
    probs = torch.from_numpy(rng.uniform(0, 1, (1, H, W, 2)))
    probs = probs / probs.sum(-1, keepdim=True)
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
