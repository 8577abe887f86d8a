"""SAM (``transformers``' ``SamModel``, ``modeling_sam.py``): the image encoder,
the prompt encoder and the mask decoder, with ``transformers``' state-dict
keys, box prompts only.

``prompt_encoder.shared_embedding.positional_embedding`` is tied to
``shared_image_embedding.positional_embedding``: both keys are in the state
dict, and ``tie_weights`` makes them one tensor again after a load or a
move (``models/foundation_import.load_weights`` calls it).
"""

from __future__ import annotations

import torch
from torch import nn

from weaklysuperviseddl_tpu_torch.models.sam.decoder import SamMaskDecoder
from weaklysuperviseddl_tpu_torch.models.sam.prompt import PositionalEmbedding, SamPromptEncoder
from weaklysuperviseddl_tpu_torch.models.sam.vision import SamVisionEncoder

TIED_KEYS = {"prompt_encoder.shared_embedding.positional_embedding":
             "shared_image_embedding.positional_embedding"}


class SamModel(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.config = config
        self.shared_image_embedding = PositionalEmbedding(config.vision_config)
        self.vision_encoder = SamVisionEncoder(config.vision_config)
        self.prompt_encoder = SamPromptEncoder(config)
        self.mask_decoder = SamMaskDecoder(config.mask_decoder_config)
        self.tie_weights()

    def tie_weights(self):
        self.prompt_encoder.shared_embedding.positional_embedding = (
            self.shared_image_embedding.positional_embedding)

    def image_wide_positional_embeddings(self) -> torch.Tensor:
        size = self.config.prompt_encoder_config.image_embedding_size
        pe = self.shared_image_embedding.positional_embedding
        grid = torch.ones((size, size), device=pe.device, dtype=pe.dtype)
        y = (grid.cumsum(dim=0) - 0.5) / size
        x = (grid.cumsum(dim=1) - 0.5) / size
        return self.shared_image_embedding(torch.stack([x, y], dim=-1)).permute(2, 0, 1)[None]

    def decode(self, image_embeddings: torch.Tensor, input_boxes: torch.Tensor):
        """Prompt encoder and mask decoder on embeddings [B, 256, h, w] and
        boxes [B, N, 4], three masks a box (``multimask_output=True``):
        (iou_scores [B, N, 3], pred_masks [B, N, 3, 4h, 4w])."""
        if input_boxes.dim() != 3:
            raise ValueError(f"input_boxes is [batch, boxes, 4], got {tuple(input_boxes.shape)}")
        pe = self.image_wide_positional_embeddings().repeat(image_embeddings.shape[0], 1, 1, 1)
        sparse, dense = self.prompt_encoder(input_boxes)
        masks, iou = self.mask_decoder(image_embeddings, pe, sparse, dense)
        return iou, masks

    def forward(self, pixel_values: torch.Tensor, input_boxes: torch.Tensor):
        return self.decode(self.vision_encoder(pixel_values), input_boxes)
