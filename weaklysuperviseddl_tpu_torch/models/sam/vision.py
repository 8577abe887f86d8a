"""SAM's image encoder: a ViT with windowed attention, decomposed relative
positions and a convolutional neck (``transformers``' ``SamVisionEncoder``,
``modeling_sam.py``; its module names, so its state-dict keys).

At 1024² and patch 16 the 64×64 token grid is padded to a multiple of the
window (70×70 at window 14) in the windowed blocks; the blocks at
``global_attn_indexes`` attend over the whole grid.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def activation(name: str):
    """``transformers``' ACT2FN for the activations these models name."""
    if name == "gelu":
        return nn.GELU()
    if name == "relu":
        return nn.ReLU()
    raise ValueError(f"activation {name!r} is not one the foundation models use")


class LayerNorm2d(nn.LayerNorm):
    """LayerNorm over the channels of an NCHW tensor (``SamLayerNorm``,
    ``data_format="channels_first"``)."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__(channels, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class MLPBlock(nn.Module):
    def __init__(self, hidden_size: int, mlp_dim: int, act: str):
        super().__init__()
        self.lin1 = nn.Linear(hidden_size, mlp_dim)
        self.lin2 = nn.Linear(mlp_dim, hidden_size)
        self.act = activation(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lin2(self.act(self.lin1(x)))


class PatchEmbeddings(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.image_size = config.image_size
        self.projection = nn.Conv2d(config.num_channels, config.hidden_size,
                                    kernel_size=config.patch_size, stride=config.patch_size)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        if tuple(pixel_values.shape[-2:]) != (self.image_size, self.image_size):
            raise ValueError(f"input image size {tuple(pixel_values.shape[-2:])} does not match "
                             f"the model's ({self.image_size}*{self.image_size})")
        return self.projection(pixel_values).permute(0, 2, 3, 1)


def _rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """The relative position embeddings of every (query, key) offset along
    one axis, [q_size, k_size, head_dim]."""
    max_rel_dist = int(2 * max(q_size, k_size) - 1)
    resized = F.interpolate(rel_pos.reshape(1, rel_pos.shape[0], -1).permute(0, 2, 1),
                            size=max_rel_dist, mode="linear")
    resized = resized.reshape(-1, max_rel_dist).permute(1, 0)
    q_coords = torch.arange(q_size, device=rel_pos.device)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size, device=rel_pos.device)[None, :] * max(q_size / k_size, 1.0)
    relative = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return resized[relative.long()]


class VisionAttention(nn.Module):
    """Multi-head attention with decomposed relative positions (MViTv2),
    computed through scaled_dot_product_attention with the positions as an
    additive bias, as ``SamVisionSdpaAttention`` does."""

    def __init__(self, config, window_size: int):
        super().__init__()
        side = config.image_size // config.patch_size if window_size == 0 else window_size
        self.num_attention_heads = config.num_attention_heads
        head_dim = config.hidden_size // config.num_attention_heads
        self.qkv = nn.Linear(config.hidden_size, config.hidden_size * 3, bias=config.qkv_bias)
        self.proj = nn.Linear(config.hidden_size, config.hidden_size)
        self.use_rel_pos = config.use_rel_pos
        if self.use_rel_pos:
            self.rel_pos_h = nn.Parameter(torch.zeros(2 * side - 1, head_dim))
            self.rel_pos_w = nn.Parameter(torch.zeros(2 * side - 1, head_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, _ = x.shape
        heads = self.num_attention_heads
        qkv = self.qkv(x).reshape(B, H * W, 3, heads, -1).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.reshape(3, B * heads, H * W, -1).unbind(0)
        bias = None
        if self.use_rel_pos:
            rh = _rel_pos(H, H, self.rel_pos_h)
            rw = _rel_pos(W, W, self.rel_pos_w)
            rq = q.reshape(B * heads, H, W, -1)
            rel_h = torch.einsum("bhwc,hkc->bhwk", rq, rh)
            rel_w = torch.einsum("bhwc,wkc->bhwk", rq, rw)
            bias = (rel_h[:, :, :, :, None] + rel_w[:, :, :, None, :]).reshape(
                B, heads, H * W, H * W)
        q = q.view(B, heads, H * W, -1)
        k = k.view(B, heads, H * W, -1)
        v = v.view(B, heads, H * W, -1)
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
        out = out.view(B, heads, H, W, -1).permute(0, 2, 3, 1, 4).reshape(B, H, W, -1)
        return self.proj(out)


class VisionLayer(nn.Module):
    def __init__(self, config, window_size: int):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps)
        self.attn = VisionAttention(config, window_size)
        self.layer_norm2 = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps)
        self.mlp = MLPBlock(config.hidden_size, config.mlp_dim, config.hidden_act)
        self.window_size = window_size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        x = self.layer_norm1(x)
        w = self.window_size
        if w > 0:
            B, H, W, C = x.shape
            ph, pw = (w - H % w) % w, (w - W % w) % w
            x = F.pad(x, (0, 0, 0, pw, 0, ph))
            Hp, Wp = H + ph, W + pw
            x = x.reshape(B, Hp // w, w, Wp // w, w, C).permute(0, 1, 3, 2, 4, 5)
            x = x.contiguous().reshape(-1, w, w, C)
        x = self.attn(x)
        if w > 0:
            x = x.reshape(B, Hp // w, Wp // w, w, w, -1).permute(0, 1, 3, 2, 4, 5)
            x = x.contiguous().reshape(B, Hp, Wp, -1)[:, :H, :W, :].contiguous()
        x = residual + x
        return x + self.mlp(self.layer_norm2(x))


class VisionNeck(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.conv1 = nn.Conv2d(config.hidden_size, config.output_channels, kernel_size=1,
                               bias=False)
        self.layer_norm1 = LayerNorm2d(config.output_channels)
        self.conv2 = nn.Conv2d(config.output_channels, config.output_channels, kernel_size=3,
                               padding=1, bias=False)
        self.layer_norm2 = LayerNorm2d(config.output_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.layer_norm1(self.conv1(x.permute(0, 3, 1, 2)))
        return self.layer_norm2(self.conv2(x))


class SamVisionEncoder(nn.Module):
    """pixel_values [B,3,S,S] → image embeddings [B, output_channels, S/16, S/16]."""

    def __init__(self, config):
        super().__init__()
        self.patch_embed = PatchEmbeddings(config)
        self.pos_embed = None
        if config.use_abs_pos:
            side = config.image_size // config.patch_size
            self.pos_embed = nn.Parameter(torch.zeros(1, side, side, config.hidden_size))
        self.layers = nn.ModuleList(
            VisionLayer(config, 0 if i in config.global_attn_indexes else config.window_size)
            for i in range(config.num_hidden_layers))
        self.neck = VisionNeck(config)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(pixel_values)
        if self.pos_embed is not None:
            x = x + self.pos_embed
        for layer in self.layers:
            x = layer(x)
        return self.neck(x)
