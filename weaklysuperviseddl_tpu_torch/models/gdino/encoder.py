"""GroundingDINO's encoder (``modeling_grounding_dino.py``): per layer, the
bi-directional image↔text fusion (``:708``, ``:895``), the text enhancer
(``:626``) and the deformable self-attention over the image levels
(``:958``), in ``GroundingDinoEncoderLayer``'s order (``:1079``), looped by
``GroundingDinoEncoder`` (``:1448``). Module names are ``transformers``'.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from weaklysuperviseddl_tpu_torch.models.gdino.deformable import MultiscaleDeformableAttention
from weaklysuperviseddl_tpu_torch.models.sam.vision import activation


def sine_pos_embed(pos: torch.Tensor, num_pos_feats: int = 128, temperature: int = 10000,
                   exchange_xy: bool = True) -> torch.Tensor:
    """Sine embedding of each coordinate in the last dimension, concatenated
    (``get_sine_pos_embed``, ``:1043``)."""
    scale = 2 * math.pi
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=pos.device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / num_pos_feats)

    def sine(x):
        x = x * scale / dim_t
        return torch.stack((x[..., 0::2].sin(), x[..., 1::2].cos()), dim=3).flatten(2)

    parts = [sine(x) for x in pos.split([1] * pos.shape[-1], dim=-1)]
    if exchange_xy:
        parts[0], parts[1] = parts[1], parts[0]
    return torch.cat(parts, dim=-1)


class MultiheadAttention(nn.Module):
    """``GroundingDinoMultiheadAttention``: an additive float mask, eager softmax."""

    def __init__(self, config, num_attention_heads: int):
        super().__init__()
        if config.d_model % num_attention_heads:
            raise ValueError(f"d_model {config.d_model} is not a multiple of the heads "
                             f"{num_attention_heads}")
        self.num_attention_heads = num_attention_heads
        self.attention_head_size = config.d_model // num_attention_heads
        self.query = nn.Linear(config.d_model, config.d_model)
        self.key = nn.Linear(config.d_model, config.d_model)
        self.value = nn.Linear(config.d_model, config.d_model)
        self.out_proj = nn.Linear(config.d_model, config.d_model)

    def forward(self, queries, keys, values, attention_mask=None):
        B, L, C = queries.shape
        heads, d = self.num_attention_heads, self.attention_head_size
        q = self.query(queries).view(B, -1, heads, d).transpose(1, 2)
        k = self.key(keys).view(B, -1, heads, d).transpose(1, 2)
        v = self.value(values).view(B, -1, heads, d).transpose(1, 2)
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(d)
        if attention_mask is not None:
            scores = scores + attention_mask
        out = torch.matmul(F.softmax(scores, dim=-1), v).permute(0, 2, 1, 3).contiguous()
        return self.out_proj(out.view(B, L, C))


class TextEnhancerLayer(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.num_heads = config.encoder_attention_heads // 2
        self.self_attn = MultiheadAttention(config, self.num_heads)
        self.fc1 = nn.Linear(config.d_model, config.encoder_ffn_dim // 2)
        self.fc2 = nn.Linear(config.encoder_ffn_dim // 2, config.d_model)
        self.layer_norm_before = nn.LayerNorm(config.d_model, config.layer_norm_eps)
        self.layer_norm_after = nn.LayerNorm(config.d_model, config.layer_norm_eps)
        self.activation = activation(config.activation_function)

    def forward(self, x, attention_masks, position_embeddings):
        """``attention_masks`` [B, L, L] bool, True where a token may attend."""
        dtype = x.dtype
        mask = attention_masks[:, None].repeat(1, self.num_heads, 1, 1).to(dtype)
        mask = (1.0 - mask) * torch.finfo(dtype).min
        qk = x + position_embeddings
        x = self.layer_norm_before(x + self.self_attn(qk, qk, x, mask))
        return self.layer_norm_after(x + self.fc2(self.activation(self.fc1(x))))


class BiMultiHeadAttention(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.embed_dim = config.encoder_ffn_dim // 2
        self.num_heads = config.encoder_attention_heads // 2
        self.head_dim = self.embed_dim // self.num_heads
        if self.head_dim * self.num_heads != self.embed_dim:
            raise ValueError(f"embed_dim {self.embed_dim} is not a multiple of the heads "
                             f"{self.num_heads}")
        self.scale = self.head_dim ** (-0.5)
        d = config.d_model
        self.vision_proj = nn.Linear(d, self.embed_dim)
        self.text_proj = nn.Linear(d, self.embed_dim)
        self.values_vision_proj = nn.Linear(d, self.embed_dim)
        self.values_text_proj = nn.Linear(d, self.embed_dim)
        self.out_vision_proj = nn.Linear(self.embed_dim, d)
        self.out_text_proj = nn.Linear(self.embed_dim, d)

    def _heads(self, x: torch.Tensor, B: int) -> torch.Tensor:
        x = x.view(B, -1, self.num_heads, self.head_dim).transpose(1, 2).contiguous()
        return x.view(B * self.num_heads, -1, self.head_dim)

    def forward(self, vision, text, vision_attention_mask, text_attention_mask):
        """Masks are [B, S] and [B, L] bool, True at padding."""
        B, S, _ = vision.shape
        L = text.shape[1]
        vq = self._heads(self.vision_proj(vision) * self.scale, B)
        tk = self._heads(self.text_proj(text), B)
        vv = self._heads(self.values_vision_proj(vision), B)
        tv = self._heads(self.values_text_proj(text), B)
        w = torch.bmm(vq, tk.transpose(1, 2))
        w = torch.clamp(w - w.max(), min=-50000, max=50000)
        wt = w.transpose(1, 2)
        wt = torch.clamp(wt - torch.max(wt, dim=-1, keepdim=True)[0], min=-50000, max=50000)
        if vision_attention_mask is not None:
            m = vision_attention_mask[:, None, None, :].repeat(1, self.num_heads, 1, 1)
            m = m.flatten(0, 1)
            wt = wt.masked_fill(m, float("-inf"))
        wt = wt.softmax(dim=-1)
        if text_attention_mask is not None:
            m = text_attention_mask[:, None, None, :].repeat(1, self.num_heads, 1, 1).flatten(0, 1)
            w = w.masked_fill(m, float("-inf"))
        w = w.softmax(dim=-1)
        vo = torch.bmm(w, tv).view(B, self.num_heads, S, self.head_dim).transpose(1, 2)
        to = torch.bmm(wt, vv).view(B, self.num_heads, L, self.head_dim).transpose(1, 2)
        return (self.out_vision_proj(vo.reshape(B, S, self.embed_dim)),
                self.out_text_proj(to.reshape(B, L, self.embed_dim)))


class FusionLayer(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.layer_norm_vision = nn.LayerNorm(config.d_model, config.layer_norm_eps)
        self.layer_norm_text = nn.LayerNorm(config.d_model, config.layer_norm_eps)
        self.attn = BiMultiHeadAttention(config)
        self.vision_param = nn.Parameter(1e-4 * torch.ones(config.d_model))
        self.text_param = nn.Parameter(1e-4 * torch.ones(config.d_model))

    def forward(self, vision, text, vision_mask, text_mask):
        vision = self.layer_norm_vision(vision)
        text = self.layer_norm_text(text)
        dv, dt = self.attn(vision, text, vision_mask, text_mask)
        return vision + self.vision_param * dv, text + self.text_param * dt


class DeformableLayer(nn.Module):
    def __init__(self, config):
        super().__init__()
        d = config.d_model
        self.self_attn = MultiscaleDeformableAttention(config, config.encoder_attention_heads,
                                                       config.encoder_n_points)
        self.self_attn_layer_norm = nn.LayerNorm(d, config.layer_norm_eps)
        self.activation_fn = activation(config.activation_function)
        self.fc1 = nn.Linear(d, config.encoder_ffn_dim)
        self.fc2 = nn.Linear(config.encoder_ffn_dim, d)
        self.final_layer_norm = nn.LayerNorm(d, config.layer_norm_eps)

    def forward(self, x, attention_mask, position_embeddings, reference_points, spatial_shapes,
                spatial_shapes_list):
        x = self.self_attn_layer_norm(x + self.self_attn(
            x, x, attention_mask, position_embeddings, reference_points, spatial_shapes,
            spatial_shapes_list))
        return self.final_layer_norm(x + self.fc2(self.activation_fn(self.fc1(x))))


class EncoderLayer(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.d_model = config.d_model
        self.text_enhancer_layer = TextEnhancerLayer(config)
        self.fusion_layer = FusionLayer(config)
        self.deformable_layer = DeformableLayer(config)

    def forward(self, vision, vision_pos, spatial_shapes, spatial_shapes_list, key_padding_mask,
                reference_points, text, text_padding_mask, text_self_attention_masks,
                text_position_ids):
        text_pos = sine_pos_embed(text_position_ids[..., None], num_pos_feats=self.d_model,
                                  exchange_xy=False)
        vision, text = self.fusion_layer(vision, text, key_padding_mask, text_padding_mask)
        text = self.text_enhancer_layer(text, text_self_attention_masks, text_pos)
        vision = self.deformable_layer(vision, ~key_padding_mask, vision_pos, reference_points,
                                       spatial_shapes, spatial_shapes_list)
        return vision, text


class GroundingDinoEncoder(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.layers = nn.ModuleList(EncoderLayer(config) for _ in range(config.encoder_layers))

    @staticmethod
    def reference_points(spatial_shapes_list, valid_ratios, device) -> torch.Tensor:
        refs = []
        for level, (h, w) in enumerate(spatial_shapes_list):
            ry, rx = torch.meshgrid(
                torch.linspace(0.5, h - 0.5, h, dtype=torch.float32, device=device),
                torch.linspace(0.5, w - 0.5, w, dtype=torch.float32, device=device),
                indexing="ij")
            ry = ry.reshape(-1)[None] / (valid_ratios[:, None, level, 1] * h)
            rx = rx.reshape(-1)[None] / (valid_ratios[:, None, level, 0] * w)
            refs.append(torch.stack((rx, ry), -1))
        return torch.cat(refs, 1)[:, :, None] * valid_ratios[:, None]

    def forward(self, vision, key_padding_mask, vision_pos, spatial_shapes, spatial_shapes_list,
                valid_ratios, text, text_padding_mask, text_self_attention_masks,
                text_position_ids):
        """``key_padding_mask`` [B, S] and ``text_padding_mask`` [B, L] are True
        at padding; ``text_self_attention_masks`` [B, L, L] True where a token
        may attend."""
        ref = self.reference_points(spatial_shapes_list, valid_ratios, vision.device)
        for layer in self.layers:
            vision, text = layer(vision, vision_pos, spatial_shapes, spatial_shapes_list,
                                 key_padding_mask, ref, text, text_padding_mask,
                                 text_self_attention_masks, text_position_ids)
        return vision, text
