"""GroundingDINO's backbone: Swin as ``transformers``' ``load_backbone`` builds it
inside ``GroundingDinoConvEncoder`` (``SwinBackbone``, ``modeling_swin.py``;
its module names, so its state-dict keys), and the sine position embedding
(``GroundingDinoSinePositionEmbedding``, ``modeling_grounding_dino.py:449``).

The backbone always partitions into windows (``always_partition=True``): each
stage pads its grid to a multiple of the window, odd blocks shift by half a
window under the shifted-window mask, and the feature maps of the stages in
``out_indices`` pass through their ``hidden_states_norms``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from weaklysuperviseddl_tpu_torch.models.sam.vision import activation


def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    B, H, W, C = x.shape
    x = x.view(B, H // w, w, W // w, w, C).permute(0, 1, 3, 2, 4, 5)
    return x.contiguous().view(-1, w, w, C)


def window_reverse(windows: torch.Tensor, w: int, H: int, W: int) -> torch.Tensor:
    C = windows.shape[-1]
    x = windows.view(-1, H // w, W // w, w, w, C).permute(0, 1, 3, 2, 4, 5)
    return x.contiguous().view(-1, H, W, C)


class PatchEmbeddings(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.patch_size = config.patch_size
        self.projection = nn.Conv2d(config.num_channels, config.embed_dim,
                                    kernel_size=config.patch_size, stride=config.patch_size)

    def forward(self, pixel_values: torch.Tensor):
        p = self.patch_size
        H, W = pixel_values.shape[-2:]
        if W % p:
            pixel_values = F.pad(pixel_values, (0, p - W % p))
        if H % p:
            pixel_values = F.pad(pixel_values, (0, 0, 0, p - H % p))
        x = self.projection(pixel_values)
        return x.flatten(2).transpose(1, 2), tuple(x.shape[-2:])


class Embeddings(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.patch_embeddings = PatchEmbeddings(config)
        self.norm = nn.LayerNorm(config.embed_dim)

    def forward(self, pixel_values: torch.Tensor):
        x, dims = self.patch_embeddings(pixel_values)
        return self.norm(x), dims


class SelfAttention(nn.Module):
    def __init__(self, config, dim: int, num_heads: int):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"the width {dim} is not a multiple of the heads {num_heads}")
        w = config.window_size
        self.num_attention_heads = num_heads
        self.attention_head_size = dim // num_heads
        self.window_size = w
        self.relative_position_bias_table = nn.Parameter(torch.zeros((2 * w - 1) ** 2, num_heads))
        coords = torch.stack(torch.meshgrid(torch.arange(w), torch.arange(w), indexing="ij"))
        coords = coords.flatten(1)
        rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0).contiguous()
        rel[:, :, 0] += w - 1
        rel[:, :, 1] += w - 1
        rel[:, :, 0] *= 2 * w - 1
        self.register_buffer("relative_position_index", rel.sum(-1))
        self.query = nn.Linear(dim, dim, bias=config.qkv_bias)
        self.key = nn.Linear(dim, dim, bias=config.qkv_bias)
        self.value = nn.Linear(dim, dim, bias=config.qkv_bias)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
        B, N, C = x.shape
        shape = (B, N, -1, self.attention_head_size)
        q = self.query(x).view(shape).transpose(1, 2)
        k = self.key(x).view(shape).transpose(1, 2)
        v = self.value(x).view(shape).transpose(1, 2)
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(self.attention_head_size)
        bias = self.relative_position_bias_table[self.relative_position_index.view(-1)]
        bias = bias.view(N, N, -1).permute(2, 0, 1).contiguous()
        scores = scores + bias.unsqueeze(0)
        if mask is not None:
            nw = mask.shape[0]
            scores = scores.view(B // nw, nw, self.num_attention_heads, N, N)
            scores = scores + mask.unsqueeze(1).unsqueeze(0)
            scores = scores.view(-1, self.num_attention_heads, N, N)
        out = torch.matmul(F.softmax(scores, dim=-1), v).permute(0, 2, 1, 3).contiguous()
        return out.view(B, N, C)


class SelfOutput(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dense = nn.Linear(dim, dim)

    def forward(self, x):
        return self.dense(x)


class Attention(nn.Module):
    def __init__(self, config, dim: int, num_heads: int):
        super().__init__()
        self.self = SelfAttention(config, dim, num_heads)
        self.output = SelfOutput(dim)

    def forward(self, x, mask):
        return self.output(self.self(x, mask))


class Intermediate(nn.Module):
    def __init__(self, config, dim: int):
        super().__init__()
        self.dense = nn.Linear(dim, int(config.mlp_ratio * dim))
        self.intermediate_act_fn = activation(config.hidden_act)

    def forward(self, x):
        return self.intermediate_act_fn(self.dense(x))


class Output(nn.Module):
    def __init__(self, config, dim: int):
        super().__init__()
        self.dense = nn.Linear(int(config.mlp_ratio * dim), dim)

    def forward(self, x):
        return self.dense(x)


class SwinLayer(nn.Module):
    def __init__(self, config, dim: int, num_heads: int, shift_size: int):
        super().__init__()
        self.shift_size = shift_size
        self.window_size = config.window_size
        self.layernorm_before = nn.LayerNorm(dim, eps=config.layer_norm_eps)
        self.attention = Attention(config, dim, num_heads)
        self.layernorm_after = nn.LayerNorm(dim, eps=config.layer_norm_eps)
        self.intermediate = Intermediate(config, dim)
        self.output = Output(config, dim)

    def attn_mask(self, H: int, W: int, dtype, device) -> torch.Tensor | None:
        if self.shift_size == 0:
            return None
        w, s = self.window_size, self.shift_size
        img = torch.zeros((1, H, W, 1), dtype=dtype, device=device)
        count = 0
        for hs in (slice(0, -w), slice(-w, -s), slice(-s, None)):
            for ws in (slice(0, -w), slice(-w, -s), slice(-s, None)):
                img[:, hs, ws, :] = count
                count += 1
        win = window_partition(img, w).view(-1, w * w)
        mask = win.unsqueeze(1) - win.unsqueeze(2)
        return mask.masked_fill(mask != 0, -100.0).masked_fill(mask == 0, 0.0)

    def forward(self, x: torch.Tensor, dims) -> torch.Tensor:
        H, W = dims
        B, _, C = x.shape
        w = self.window_size
        shortcut = x
        x = self.layernorm_before(x).view(B, H, W, C)
        pad_r, pad_b = (w - W % w) % w, (w - H % w) % w
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        Hp, Wp = x.shape[1:3]
        if self.shift_size > 0:
            x = torch.roll(x, shifts=(-self.shift_size, -self.shift_size), dims=(1, 2))
        windows = window_partition(x, w).view(-1, w * w, C)
        out = self.attention(windows, self.attn_mask(Hp, Wp, x.dtype, x.device))
        x = window_reverse(out.view(-1, w, w, C), w, Hp, Wp)
        if self.shift_size > 0:
            x = torch.roll(x, shifts=(self.shift_size, self.shift_size), dims=(1, 2))
        if pad_r or pad_b:
            x = x[:, :H, :W, :].contiguous()
        x = shortcut + x.view(B, H * W, C)
        return x + self.output(self.intermediate(self.layernorm_after(x)))


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(4 * dim)

    def forward(self, x: torch.Tensor, dims) -> torch.Tensor:
        H, W = dims
        B, _, C = x.shape
        x = x.view(B, H, W, C)
        if H % 2 or W % 2:
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
        return self.reduction(self.norm(x.view(B, -1, 4 * C)))


class SwinStage(nn.Module):
    def __init__(self, config, dim: int, depth: int, num_heads: int, downsample: bool):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinLayer(config, dim, num_heads, 0 if i % 2 == 0 else config.window_size // 2)
            for i in range(depth))
        self.downsample = PatchMerging(dim) if downsample else None

    def forward(self, x, dims):
        for block in self.blocks:
            x = block(x, dims)
        before = x
        if self.downsample is not None:
            H, W = dims
            return self.downsample(before, dims), before, ((H + 1) // 2, (W + 1) // 2)
        return x, before, dims


class Encoder(nn.Module):
    def __init__(self, config):
        super().__init__()
        n = len(config.depths)
        self.layers = nn.ModuleList(
            SwinStage(config, config.embed_dim * 2 ** i, config.depths[i], config.num_heads[i],
                      downsample=i < n - 1)
            for i in range(n))


class SwinBackbone(nn.Module):
    """pixel_values [B,3,H,W] → the normed feature maps of the stages in
    ``out_indices`` (stage i, 1-based, is ``embed_dim·2^(i-1)`` wide)."""

    def __init__(self, config):
        super().__init__()
        self.out_indices = list(config.out_indices)
        if min(self.out_indices) < 1 or max(self.out_indices) > len(config.depths):
            raise ValueError(f"out_indices {self.out_indices} outside stages "
                             f"1-{len(config.depths)}")
        self.channels = [config.embed_dim * 2 ** (i - 1) for i in self.out_indices]
        self.embeddings = Embeddings(config)
        self.encoder = Encoder(config)
        self.hidden_states_norms = nn.ModuleDict(
            {f"stage{i}": nn.LayerNorm(c) for i, c in zip(self.out_indices, self.channels)})

    def forward(self, pixel_values: torch.Tensor) -> list[torch.Tensor]:
        x, dims = self.embeddings(pixel_values)
        maps = []
        for i, stage in enumerate(self.encoder.layers, start=1):
            x, before, next_dims = stage(x, dims)
            if i in self.out_indices:
                B, _, C = before.shape
                y = self.hidden_states_norms[f"stage{i}"](before)
                maps.append(y.view(B, *dims, C).permute(0, 3, 1, 2).contiguous())
            dims = next_dims
        return maps


class SinePositionEmbedding(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.embedding_dim = config.d_model // 2
        self.temperature = config.positional_embedding_temperature
        self.scale = 2 * math.pi

    def forward(self, pixel_values: torch.Tensor, pixel_mask: torch.Tensor) -> torch.Tensor:
        y = pixel_mask.cumsum(1, dtype=torch.float32)
        x = pixel_mask.cumsum(2, dtype=torch.float32)
        eps = 1e-6
        y = y / (y[:, -1:, :] + eps) * self.scale
        x = x / (x[:, :, -1:] + eps) * self.scale
        dim_t = torch.arange(self.embedding_dim, dtype=torch.float32, device=pixel_values.device)
        dim_t = self.temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor")
                                     / self.embedding_dim)
        px = x[:, :, :, None] / dim_t
        py = y[:, :, :, None] / dim_t
        px = torch.stack((px[:, :, :, 0::2].sin(), px[:, :, :, 1::2].cos()), dim=4).flatten(3)
        py = torch.stack((py[:, :, :, 0::2].sin(), py[:, :, :, 1::2].cos()), dim=4).flatten(3)
        return torch.cat((py, px), dim=3).permute(0, 3, 1, 2)
