"""SAM's prompt encoder (``transformers``' ``SamPositionalEmbedding``,
``SamMaskEmbedding``, ``SamPromptEncoder``, ``modeling_sam.py``): box corners
through the random-Fourier positional encoding plus their point embeddings,
and the no-mask dense embedding. The mask input and point prompts keep their
modules (the checkpoint holds them); the foundation pipeline prompts with
boxes only.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from weaklysuperviseddl_tpu_torch.models.sam.vision import LayerNorm2d, activation


class PositionalEmbedding(nn.Module):
    """Random-Fourier features of coordinates in [0, 1]; the Gaussian matrix
    is a buffer of the checkpoint."""

    def __init__(self, vision_config):
        super().__init__()
        self.scale = vision_config.hidden_size // 2
        self.register_buffer("positional_embedding",
                             self.scale * torch.randn((2, vision_config.num_pos_feats)))

    def forward(self, coords: torch.Tensor, input_shape=None) -> torch.Tensor:
        coords = coords.clone()
        if input_shape is not None:
            coords[..., 0] = coords[..., 0] / input_shape[1]
            coords[..., 1] = coords[..., 1] / input_shape[0]
        coords = 2 * coords - 1
        coords = coords.to(self.positional_embedding.dtype) @ self.positional_embedding
        coords = 2 * math.pi * coords
        return torch.cat([torch.sin(coords), torch.cos(coords)], dim=-1)


class MaskEmbedding(nn.Module):
    def __init__(self, config):
        super().__init__()
        c = config.mask_input_channels // 4
        self.activation = activation(config.hidden_act)
        self.conv1 = nn.Conv2d(1, c, kernel_size=2, stride=2)
        self.conv2 = nn.Conv2d(c, config.mask_input_channels, kernel_size=2, stride=2)
        self.conv3 = nn.Conv2d(config.mask_input_channels, config.hidden_size, kernel_size=1)
        self.layer_norm1 = LayerNorm2d(c, eps=config.layer_norm_eps)
        self.layer_norm2 = LayerNorm2d(c * 4, eps=config.layer_norm_eps)

    def forward(self, masks: torch.Tensor) -> torch.Tensor:
        x = self.activation(self.layer_norm1(self.conv1(masks)))
        x = self.activation(self.layer_norm2(self.conv2(x)))
        return self.conv3(x)


class SamPromptEncoder(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.shared_embedding = PositionalEmbedding(config.vision_config)
        pc = config.prompt_encoder_config
        self.mask_embed = MaskEmbedding(pc)
        self.no_mask_embed = nn.Embedding(1, pc.hidden_size)
        self.image_embedding_size = (pc.image_embedding_size, pc.image_embedding_size)
        self.input_image_size = pc.image_size
        self.point_embed = nn.ModuleList(nn.Embedding(1, pc.hidden_size)
                                         for _ in range(pc.num_point_embeddings))
        self.not_a_point_embed = nn.Embedding(1, pc.hidden_size)

    def embed_boxes(self, boxes: torch.Tensor) -> torch.Tensor:
        """boxes [B, N, 4] (x0, y0, x1, y1) in the resized frame → [B, N, 2, hidden]."""
        boxes = boxes + 0.5  # the centre of the pixel
        B, N = boxes.shape[:2]
        size = (self.input_image_size, self.input_image_size)
        corners = self.shared_embedding(boxes.reshape(B, N, 2, 2), size)
        corners[:, :, 0, :] += self.point_embed[2].weight
        corners[:, :, 1, :] += self.point_embed[3].weight
        return corners

    def forward(self, input_boxes: torch.Tensor):
        """Sparse [B, N, 2, hidden] and dense [B, hidden, h, w] embeddings of
        box prompts with no mask input."""
        sparse = self.embed_boxes(input_boxes)
        dense = self.no_mask_embed.weight.reshape(1, -1, 1, 1).expand(
            input_boxes.shape[0], -1, *self.image_embedding_size)
        return sparse, dense
