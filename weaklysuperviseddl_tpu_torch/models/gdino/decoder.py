"""GroundingDINO's two-stage query selection and decoder
(``modeling_grounding_dino.py``): encoder output proposals (``:1997``), the
contrastive class head (``:1349``), the top-``num_queries`` proposals as
sigmoid reference points, and the decoder layers (``:1231``: self-attention,
text cross-attention, deformable cross-attention, FFN) with iterative box
refinement through the shared MLP box head (``:2319``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from weaklysuperviseddl_tpu_torch.models.gdino.deformable import MultiscaleDeformableAttention
from weaklysuperviseddl_tpu_torch.models.gdino.encoder import MultiheadAttention, sine_pos_embed
from weaklysuperviseddl_tpu_torch.models.sam.vision import activation


class MLPPredictionHead(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, num_layers: int):
        super().__init__()
        self.num_layers = num_layers
        h = [hidden_dim] * (num_layers - 1)
        self.layers = nn.ModuleList(nn.Linear(n, k)
                                    for n, k in zip([input_dim] + h, h + [output_dim]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = F.relu(layer(x)) if i < self.num_layers - 1 else layer(x)
        return x


class ContrastiveEmbedding(nn.Module):
    """Query·token similarity, -inf at padded tokens and past the text, padded
    to ``max_text_len`` columns."""

    def __init__(self, config):
        super().__init__()
        self.max_text_len = config.max_text_len

    def forward(self, vision, text, text_token_mask):
        out = (vision @ text.transpose(-1, -2)).masked_fill(~text_token_mask[:, None, :],
                                                             float("-inf"))
        full = torch.full((*out.shape[:-1], self.max_text_len), float("-inf"), device=out.device)
        full[..., :out.shape[-1]] = out
        return full


def encoder_output_proposals(enc_output, padding_mask, spatial_shapes_list):
    """(memory of the valid proposals [B, S, d], proposals [B, S, 4] as
    inverse sigmoids, +inf where invalid); ``padding_mask`` True at padding."""
    B = enc_output.shape[0]
    proposals, start = [], 0
    for level, (h, w) in enumerate(spatial_shapes_list):
        m = padding_mask[:, start:start + h * w].view(B, h, w, 1)
        valid_h = torch.sum(~m[:, :, 0, 0], 1)
        valid_w = torch.sum(~m[:, 0, :, 0], 1)
        gy, gx = torch.meshgrid(
            torch.linspace(0, h - 1, h, dtype=torch.float32, device=enc_output.device),
            torch.linspace(0, w - 1, w, dtype=torch.float32, device=enc_output.device),
            indexing="ij")
        grid = torch.cat([gx.unsqueeze(-1), gy.unsqueeze(-1)], -1)
        scale = torch.cat([valid_w.unsqueeze(-1), valid_h.unsqueeze(-1)], 1).view(B, 1, 1, 2)
        grid = (grid.unsqueeze(0).expand(B, -1, -1, -1) + 0.5) / scale
        wh = torch.ones_like(grid) * 0.05 * (2.0 ** level)
        proposals.append(torch.cat((grid, wh), -1).view(B, -1, 4))
        start += h * w
    props = torch.cat(proposals, 1)
    valid = ((props > 0.01) & (props < 0.99)).all(-1, keepdim=True)
    props = torch.log(props / (1 - props))
    props = props.masked_fill(padding_mask.unsqueeze(-1), float("inf"))
    props = props.masked_fill(~valid, float("inf"))
    memory = enc_output.masked_fill(padding_mask.unsqueeze(-1), 0.0).masked_fill(~valid, 0.0)
    return memory, props


class DecoderLayer(nn.Module):
    def __init__(self, config):
        super().__init__()
        d, eps = config.d_model, config.layer_norm_eps
        self.self_attn = MultiheadAttention(config, config.decoder_attention_heads)
        self.activation_fn = activation(config.activation_function)
        self.self_attn_layer_norm = nn.LayerNorm(d, eps)
        self.encoder_attn_text = MultiheadAttention(config, config.decoder_attention_heads)
        self.encoder_attn_text_layer_norm = nn.LayerNorm(d, eps)
        self.encoder_attn = MultiscaleDeformableAttention(config, config.decoder_attention_heads,
                                                          config.decoder_n_points)
        self.encoder_attn_layer_norm = nn.LayerNorm(d, eps)
        self.fc1 = nn.Linear(d, config.decoder_ffn_dim)
        self.fc2 = nn.Linear(config.decoder_ffn_dim, d)
        self.final_layer_norm = nn.LayerNorm(d, eps)

    def forward(self, x, query_pos, reference_points, spatial_shapes, spatial_shapes_list,
                vision, vision_mask, text, text_mask):
        qk = x + query_pos
        x = self.self_attn_layer_norm(x + self.self_attn(qk, qk, x))
        x = self.encoder_attn_text_layer_norm(
            x + self.encoder_attn_text(x + query_pos, text, text, text_mask))
        x = self.encoder_attn_layer_norm(x + self.encoder_attn(
            x, vision, vision_mask, query_pos, reference_points, spatial_shapes,
            spatial_shapes_list))
        return self.final_layer_norm(x + self.fc2(self.activation_fn(self.fc1(x))))


class GroundingDinoDecoder(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.config = config
        self.layer_norm = nn.LayerNorm(config.d_model, config.layer_norm_eps)
        self.layers = nn.ModuleList(DecoderLayer(config) for _ in range(config.decoder_layers))
        self.reference_points_head = MLPPredictionHead(config.query_dim // 2 * config.d_model,
                                                       config.d_model, config.d_model, 2)
        self.bbox_embed = None  # the detection head's ModuleList, set by the model

    def forward(self, target, vision, vision_mask, text, text_padding_mask, reference_points,
                spatial_shapes, spatial_shapes_list, valid_ratios):
        """(layer-normed hidden states of every layer [B, layers, Q, d], the
        reference points after every layer [B, layers, Q, 4]); the masks are
        True at real pixels (``vision_mask``) and at padded tokens."""
        dtype = text.dtype
        text_mask = text_padding_mask[:, None, None, :].repeat(
            1, self.config.decoder_attention_heads, self.config.num_queries, 1)
        text_mask = text_mask.to(dtype) * torch.finfo(dtype).min
        x = target
        hidden, refs = [], []
        for idx, layer in enumerate(self.layers):
            ref_input = reference_points[:, :, None] * torch.cat([valid_ratios, valid_ratios],
                                                                  -1)[:, None]
            query_pos = self.reference_points_head(
                sine_pos_embed(ref_input[:, :, 0, :], num_pos_feats=self.config.d_model // 2))
            x = layer(x, query_pos, ref_input, spatial_shapes, spatial_shapes_list, vision,
                      vision_mask, text, text_mask)
            delta = self.bbox_embed[idx](x)
            reference_points = (delta + torch.special.logit(reference_points, eps=1e-5)).sigmoid()
            hidden.append(self.layer_norm(x))
            refs.append(reference_points)
        return torch.stack(hidden, dim=1), torch.stack(refs, dim=1)
