"""GroundingDINO (``transformers``' ``GroundingDinoModel`` and
``GroundingDinoForObjectDetection``, ``modeling_grounding_dino.py``) with its
state-dict keys: the Swin backbone and sine positions, the input
projections and the extra level, BERT and its projection, the encoder, the
two-stage query selection, the decoder and the detection heads.

The box head is one MLP shared by every decoder layer
(``decoder_bbox_embed_share``): ``bbox_embed.N`` and
``model.decoder.bbox_embed.N`` are the same tensors, and a checkpoint that
holds them once is re-tied by ``models/foundation_import.py``.

``forward`` returns (logits [B, Q, max_text_len], pred_boxes [B, Q, 4] cxcywh
in [0, 1]); ``stages`` names the pieces that ``chip_smoke.py`` times.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from weaklysuperviseddl_tpu_torch.models.gdino.bert import BertModel, phrase_masks
from weaklysuperviseddl_tpu_torch.models.gdino.decoder import (
    ContrastiveEmbedding,
    GroundingDinoDecoder,
    MLPPredictionHead,
    encoder_output_proposals,
)
from weaklysuperviseddl_tpu_torch.models.gdino.encoder import GroundingDinoEncoder
from weaklysuperviseddl_tpu_torch.models.gdino.swin import SinePositionEmbedding, SwinBackbone


class ConvEncoder(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.model = SwinBackbone(config.backbone_config)
        self.intermediate_channel_sizes = self.model.channels

    def forward(self, pixel_values, pixel_mask):
        out = []
        for fmap in self.model(pixel_values):
            mask = F.interpolate(pixel_mask[None].float(), size=fmap.shape[-2:]).to(torch.bool)[0]
            out.append((fmap, mask))
        return out


class ConvModel(nn.Module):
    def __init__(self, conv_encoder, position_embedding):
        super().__init__()
        self.conv_encoder = conv_encoder
        self.position_embedding = position_embedding

    def forward(self, pixel_values, pixel_mask):
        out = self.conv_encoder(pixel_values, pixel_mask)
        return out, [self.position_embedding(f, m).to(f.dtype) for f, m in out]


def _proj(in_channels: int, d: int, **conv) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(in_channels, d, **conv), nn.GroupNorm(32, d))


class GroundingDinoModel(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.config = config
        conv = ConvEncoder(config)
        self.backbone = ConvModel(conv, SinePositionEmbedding(config))
        d, sizes = config.d_model, conv.intermediate_channel_sizes
        if config.num_feature_levels > 1:
            projs = [_proj(c, d, kernel_size=1) for c in sizes]
            in_channels = sizes[-1]
            for _ in range(config.num_feature_levels - len(sizes)):
                projs.append(_proj(in_channels, d, kernel_size=3, stride=2, padding=1))
                in_channels = d
        else:
            projs = [_proj(sizes[-1], d, kernel_size=1)]
        self.input_proj_vision = nn.ModuleList(projs)
        self.text_backbone = BertModel(config.text_config)
        self.text_projection = nn.Linear(config.text_config.hidden_size, d)
        self.query_position_embeddings = nn.Embedding(config.num_queries, d)
        self.encoder = GroundingDinoEncoder(config)
        self.decoder = GroundingDinoDecoder(config)
        self.level_embed = nn.Parameter(torch.zeros(config.num_feature_levels, d))
        self.enc_output = nn.Linear(d, d)
        self.enc_output_norm = nn.LayerNorm(d, config.layer_norm_eps)
        self.encoder_output_bbox_embed = MLPPredictionHead(d, d, 4, 3)
        self.encoder_output_class_embed = ContrastiveEmbedding(config)

    def text_features(self, input_ids, token_type_ids, attention_mask):
        """(projected BERT features [B, L, d], text token mask [B, L] bool,
        phrase masks [B, L, L], position ids [B, L]), cut to ``max_text_len``."""
        self_masks, position_ids = phrase_masks(input_ids)
        token_mask = attention_mask.bool()
        n = self.config.max_text_len
        if self_masks.shape[1] > n:
            self_masks, position_ids = self_masks[:, :n, :n], position_ids[:, :n]
            input_ids, token_type_ids, token_mask = (input_ids[:, :n], token_type_ids[:, :n],
                                                     token_mask[:, :n])
        text = self.text_backbone(input_ids, self_masks, token_type_ids, position_ids)
        return self.text_projection(text), token_mask, self_masks, position_ids

    def vision_features(self, pixel_values, pixel_mask):
        """The flattened levels: (sources [B, S, d], masks [B, S] True at
        real pixels, positions [B, S, d], level shapes, valid ratios [B, levels, 2])."""
        features, positions = self.backbone(pixel_values, pixel_mask)
        maps = [self.input_proj_vision[i](f) for i, (f, _) in enumerate(features)]
        masks = [m for _, m in features]
        for level in range(len(maps), self.config.num_feature_levels):
            src = self.input_proj_vision[level](features[-1][0] if level == len(features)
                                                else maps[-1])
            mask = F.interpolate(pixel_mask[None].float(), size=src.shape[-2:]).to(torch.bool)[0]
            maps.append(src)
            masks.append(mask)
            positions.append(self.backbone.position_embedding(src, mask).to(src.dtype))
        shapes = [tuple(m.shape[-2:]) for m in maps]
        src = torch.cat([m.flatten(2).transpose(1, 2) for m in maps], 1)
        mask = torch.cat([m.flatten(1) for m in masks], 1)
        pos = torch.cat([p.flatten(2).transpose(1, 2) + self.level_embed[i].view(1, 1, -1)
                         for i, p in enumerate(positions)], 1)
        valid = torch.stack([self._valid_ratio(m) for m in masks], 1).float()
        return src, mask, pos, shapes, valid

    @staticmethod
    def _valid_ratio(mask):
        _, H, W = mask.shape
        vh = torch.sum(mask[:, :, 0], 1).float() / H
        vw = torch.sum(mask[:, 0, :], 1).float() / W
        return torch.stack([vw, vh], -1)

    def encode(self, text, token_mask, self_masks, position_ids, src, mask, pos, shapes, valid):
        spatial = torch.as_tensor(shapes, dtype=torch.long, device=src.device)
        vision, text = self.encoder(src, ~mask, pos, spatial, shapes, valid, text, ~token_mask,
                                    self_masks, position_ids)
        return vision, text, spatial

    def select_queries(self, vision, text, token_mask, mask, shapes):
        """Two-stage selection: the top-``num_queries`` encoder proposals by
        their best token logit. Returns (target [B, Q, d], sigmoid reference
        points [B, Q, 4], the chosen proposals [B, Q], every proposal's best
        logit [B, S])."""
        memory, proposals = encoder_output_proposals(vision, ~mask, shapes)
        memory = self.enc_output_norm(self.enc_output(memory))
        best = self.encoder_output_class_embed(memory, text, token_mask).max(-1)[0]
        coords = self.encoder_output_bbox_embed(memory) + proposals
        topk = torch.topk(best, self.config.num_queries, dim=1)[1]
        ref = torch.gather(coords, 1, topk.unsqueeze(-1).repeat(1, 1, 4)).sigmoid()
        target = self.query_position_embeddings.weight.unsqueeze(0).repeat(vision.shape[0], 1, 1)
        return target, ref, topk, best


class GroundingDinoForObjectDetection(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.config = config
        self.model = GroundingDinoModel(config)
        class_embed = ContrastiveEmbedding(config)
        d = config.d_model
        if config.decoder_bbox_embed_share:
            shared = MLPPredictionHead(d, d, 4, 3)
            self.bbox_embed = nn.ModuleList([shared] * config.decoder_layers)
        else:
            self.bbox_embed = nn.ModuleList(MLPPredictionHead(d, d, 4, 3)
                                            for _ in range(config.decoder_layers))
        self.class_embed = nn.ModuleList([class_embed] * config.decoder_layers)
        self.model.decoder.bbox_embed = self.bbox_embed

    def heads(self, hidden, init_ref, refs, text, token_mask):
        """The last decoder layer's (logits, boxes)."""
        last = hidden.shape[1] - 1
        ref = init_ref if last == 0 else refs[:, last - 1]
        logits = self.class_embed[last](hidden[:, last], text, token_mask)
        boxes = (self.bbox_embed[last](hidden[:, last])
                 + torch.special.logit(ref, eps=1e-5)).sigmoid()
        return logits, boxes

    def stages(self, pixel_values, input_ids, token_type_ids=None, attention_mask=None,
               pixel_mask=None):
        """The forward stage by stage, yielding (name, result) as each is
        queued: "swin" (the flattened levels), "bert" (the text features),
        "encoder" (vision, text) and "decoder" (logits, pred_boxes, the
        chosen proposals [B, Q], every proposal's best logit [B, S])."""
        m = self.model
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        if pixel_mask is None:
            B, _, H, W = pixel_values.shape
            pixel_mask = torch.ones((B, H, W), dtype=torch.long, device=pixel_values.device)
        vis = m.vision_features(pixel_values, pixel_mask)
        yield "swin", vis
        txt = m.text_features(input_ids, token_type_ids, attention_mask)
        yield "bert", txt
        text, token_mask, self_masks, position_ids = txt
        src, mask, pos, shapes, valid = vis
        vision, text, spatial = m.encode(text, token_mask, self_masks, position_ids, src, mask,
                                         pos, shapes, valid)
        yield "encoder", (vision, text)
        target, ref, topk, best = m.select_queries(vision, text, token_mask, mask, shapes)
        hidden, refs = m.decoder(target, vision, mask, text, ~token_mask, ref, spatial, shapes,
                                 valid)
        yield "decoder", (*self.heads(hidden, ref, refs, text, token_mask), topk, best)

    def forward(self, pixel_values, input_ids, token_type_ids=None, attention_mask=None,
                pixel_mask=None):
        for _, out in self.stages(pixel_values, input_ids, token_type_ids, attention_mask,
                                  pixel_mask):
            pass
        return out[0], out[1]
