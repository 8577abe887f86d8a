"""Multi-scale deformable attention in plain PyTorch
(``modeling_grounding_dino.py:46-107``, ``:516-625``): each query samples
``n_points`` locations a level and head around its reference point with
``grid_sample`` (bilinear, zero padding, ``align_corners=False``, grid
``2·loc − 1``) and sums them under softmax weights. This is the path
``transformers`` takes without its custom kernel; it replaces no TPU kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def ms_deform_attn(value: torch.Tensor, spatial_shapes_list, sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    """value [B, S, heads, d], sampling_locations [B, Q, heads, levels, points, 2]
    in [0, 1], attention_weights [B, Q, heads, levels, points] → [B, Q, heads·d]."""
    B, _, heads, d = value.shape
    _, Q, _, levels, points, _ = sampling_locations.shape
    values = value.split([h * w for h, w in spatial_shapes_list], dim=1)
    grids = 2 * sampling_locations - 1
    sampled = []
    for level, (h, w) in enumerate(spatial_shapes_list):
        v = values[level].flatten(2).transpose(1, 2).reshape(B * heads, d, h, w)
        g = grids[:, :, :, level].transpose(1, 2).flatten(0, 1)
        sampled.append(F.grid_sample(v, g, mode="bilinear", padding_mode="zeros",
                                     align_corners=False))
    weights = attention_weights.transpose(1, 2).reshape(B * heads, 1, Q, levels * points)
    out = (torch.stack(sampled, dim=-2).flatten(-2) * weights).sum(-1).view(B, heads * d, Q)
    return out.transpose(1, 2).contiguous()


class MultiscaleDeformableAttention(nn.Module):
    def __init__(self, config, num_heads: int, n_points: int):
        super().__init__()
        if config.d_model % num_heads:
            raise ValueError(f"d_model {config.d_model} is not a multiple of the heads {num_heads}")
        self.d_model = config.d_model
        self.n_levels = config.num_feature_levels
        self.n_heads = num_heads
        self.n_points = n_points
        self.sampling_offsets = nn.Linear(config.d_model, num_heads * self.n_levels * n_points * 2)
        self.attention_weights = nn.Linear(config.d_model, num_heads * self.n_levels * n_points)
        self.value_proj = nn.Linear(config.d_model, config.d_model)
        self.output_proj = nn.Linear(config.d_model, config.d_model)

    def forward(self, hidden_states, encoder_hidden_states, attention_mask, position_embeddings,
                reference_points, spatial_shapes, spatial_shapes_list):
        """``attention_mask`` [B, S] bool, True at real (unpadded) pixels;
        ``reference_points`` [B, Q, levels, 2 or 4]."""
        if position_embeddings is not None:
            hidden_states = hidden_states + position_embeddings
        B, Q, _ = hidden_states.shape
        _, S, _ = encoder_hidden_states.shape
        if sum(h * w for h, w in spatial_shapes_list) != S:
            raise ValueError("the spatial shapes do not cover the encoder's sequence")
        value = self.value_proj(encoder_hidden_states)
        if attention_mask is not None:
            value = value.masked_fill(~attention_mask[..., None], 0.0)
        value = value.view(B, S, self.n_heads, self.d_model // self.n_heads)
        offsets = self.sampling_offsets(hidden_states).view(
            B, Q, self.n_heads, self.n_levels, self.n_points, 2)
        weights = F.softmax(self.attention_weights(hidden_states).view(
            B, Q, self.n_heads, self.n_levels * self.n_points), -1).view(
            B, Q, self.n_heads, self.n_levels, self.n_points)
        if reference_points.shape[-1] == 2:
            normalizer = torch.stack([spatial_shapes[..., 1], spatial_shapes[..., 0]], -1)
            locations = (reference_points[:, :, None, :, None, :]
                         + offsets / normalizer[None, None, None, :, None, :])
        elif reference_points.shape[-1] == 4:
            wh = reference_points[:, :, None, :, None, 2:]
            locations = (reference_points[:, :, None, :, None, :2]
                         + offsets / self.n_points * wh * 0.5)
        else:
            raise ValueError(f"reference points end in 2 or 4, got {reference_points.shape[-1]}")
        return self.output_proj(ms_deform_attn(value, spatial_shapes_list, locations, weights))
