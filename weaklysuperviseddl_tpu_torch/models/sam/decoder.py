"""SAM's mask decoder (``transformers``' ``SamAttention``,
``SamTwoWayAttentionBlock``, ``SamTwoWayTransformer``, ``SamFeedForward``,
``SamMaskDecoder``, ``modeling_sam.py``): a two-way transformer between the
output and prompt tokens and the image embedding, the upscaling convolutions,
one hypernetwork MLP per mask token and the IoU head.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from weaklysuperviseddl_tpu_torch.models.sam.vision import LayerNorm2d, MLPBlock


class Attention(nn.Module):
    """Attention whose projections may narrow the width by ``downsample_rate``;
    inputs are [B, point_batch, tokens, hidden]."""

    def __init__(self, config, downsample_rate: int | None = None):
        super().__init__()
        rate = config.attention_downsample_rate if downsample_rate is None else downsample_rate
        inner = config.hidden_size // rate
        if inner % config.num_attention_heads:
            raise ValueError("num_attention_heads must divide hidden_size")
        self.num_attention_heads = config.num_attention_heads
        self.q_proj = nn.Linear(config.hidden_size, inner)
        self.k_proj = nn.Linear(config.hidden_size, inner)
        self.v_proj = nn.Linear(config.hidden_size, inner)
        self.out_proj = nn.Linear(inner, config.hidden_size)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        B, P, N, C = x.shape
        return x.reshape(B * P, N, self.num_attention_heads, C // self.num_attention_heads
                         ).transpose(1, 2)

    def forward(self, query, key, value):
        P = query.shape[1]
        q, k, v = (self._heads(self.q_proj(query)), self._heads(self.k_proj(key)),
                   self._heads(self.v_proj(value)))
        out = F.scaled_dot_product_attention(q, k, v).transpose(1, 2)
        BP, N, H, D = out.shape
        return self.out_proj(out.reshape(BP // P, P, N, H * D))


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, config, skip_first_layer_pe: bool = False):
        super().__init__()
        h, eps = config.hidden_size, config.layer_norm_eps
        self.self_attn = Attention(config, downsample_rate=1)
        self.layer_norm1 = nn.LayerNorm(h, eps=eps)
        self.cross_attn_token_to_image = Attention(config)
        self.layer_norm2 = nn.LayerNorm(h, eps=eps)
        self.mlp = MLPBlock(h, config.mlp_dim, config.hidden_act)
        self.layer_norm3 = nn.LayerNorm(h, eps=eps)
        self.layer_norm4 = nn.LayerNorm(h, eps=eps)
        self.cross_attn_image_to_token = Attention(config)
        self.skip_first_layer_pe = skip_first_layer_pe

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.layer_norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.layer_norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.layer_norm3(queries + self.mlp(queries))
        q, k = queries + query_pe, keys + key_pe
        keys = self.layer_norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.layers = nn.ModuleList(TwoWayAttentionBlock(config, skip_first_layer_pe=(i == 0))
                                    for i in range(config.num_hidden_layers))
        self.final_attn_token_to_image = Attention(config)
        self.layer_norm_final_attn = nn.LayerNorm(config.hidden_size)  # eps 1e-5, as SAM's

    def forward(self, point_embeddings, image_embeddings, image_pe):
        keys = image_embeddings.flatten(2).permute(0, 2, 1).unsqueeze(1)
        key_pe = image_pe.flatten(2).permute(0, 2, 1).unsqueeze(1)
        queries = point_embeddings
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embeddings, key_pe)
        q, k = queries + point_embeddings, keys + key_pe
        queries = self.layer_norm_final_attn(queries + self.final_attn_token_to_image(q, k, keys))
        return queries, keys


class FeedForward(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, num_layers: int):
        super().__init__()
        self.proj_in = nn.Linear(input_dim, hidden_dim)
        self.proj_out = nn.Linear(hidden_dim, output_dim)
        self.layers = nn.ModuleList(nn.Linear(hidden_dim, hidden_dim)
                                    for _ in range(num_layers - 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.proj_in(x))
        for layer in self.layers:
            x = F.relu(layer(x))
        return self.proj_out(x)


class SamMaskDecoder(nn.Module):
    def __init__(self, config):
        super().__init__()
        h = config.hidden_size
        self.num_mask_tokens = config.num_multimask_outputs + 1
        self.iou_token = nn.Embedding(1, h)
        self.mask_tokens = nn.Embedding(self.num_mask_tokens, h)
        self.transformer = TwoWayTransformer(config)
        self.upscale_conv1 = nn.ConvTranspose2d(h, h // 4, kernel_size=2, stride=2)
        self.upscale_conv2 = nn.ConvTranspose2d(h // 4, h // 8, kernel_size=2, stride=2)
        self.upscale_layer_norm = LayerNorm2d(h // 4)
        self.activation = nn.GELU()
        self.output_hypernetworks_mlps = nn.ModuleList(
            FeedForward(h, h, h // 8, 3) for _ in range(self.num_mask_tokens))
        self.iou_prediction_head = FeedForward(h, config.iou_head_hidden_dim,
                                               self.num_mask_tokens, config.iou_head_depth)

    def forward(self, image_embeddings, image_pe, sparse, dense):
        """The multimask outputs: masks [B, P, 3, 4h, 4w] (logits) and IoU
        predictions [B, P, 3] (the single-mask token 0 is dropped)."""
        B, C, H, W = image_embeddings.shape
        P = sparse.shape[1]
        tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight], dim=0)
        tokens = torch.cat((tokens.repeat(B, P, 1, 1), sparse), dim=2)
        image = (image_embeddings + dense).repeat_interleave(P, 0)
        image_pe = image_pe.repeat_interleave(P, 0)
        tokens, image = self.transformer(tokens, image, image_pe)
        iou_out = tokens[:, :, 0, :]
        mask_out = tokens[:, :, 1:1 + self.num_mask_tokens, :]
        image = image.transpose(2, 3).reshape(B * P, C, H, W)
        up = self.activation(self.upscale_layer_norm(self.upscale_conv1(image)))
        up = self.activation(self.upscale_conv2(up))
        hyper = torch.stack([mlp(mask_out[:, :, i, :])
                             for i, mlp in enumerate(self.output_hypernetworks_mlps)], dim=2)
        _, c, h, w = up.shape
        masks = (hyper @ up.reshape(B, P, c, h * w)).reshape(B, P, -1, h, w)
        iou = self.iou_prediction_head(iou_out)
        return masks[:, :, 1:], iou[:, :, 1:]
