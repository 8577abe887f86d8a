"""GroundingDINO's text encoder: BERT (``transformers``' ``BertModel`` without
the pooler, ``modeling_bert.py``; its module names, so its state-dict keys)
under GroundingDINO's phrase masks and position ids
(``generate_masks_with_special_tokens_and_transfer_map``,
``modeling_grounding_dino.py:1863``).

``SPECIAL_TOKENS`` are bert-base-uncased's ids of [CLS], [SEP], "." and "?",
hard-coded as in ``transformers``: a vocabulary that puts them elsewhere (the
JAX package's 11-token test vocab) splits no phrase, and every token then
attends only to itself with position id 0. The port does the same.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from weaklysuperviseddl_tpu_torch.models.sam.vision import activation

SPECIAL_TOKENS = [101, 102, 1012, 1029]


def phrase_masks(input_ids: torch.Tensor):
    """(text self-attention mask [B, L, L] bool, position ids [B, L] int64):
    each phrase between special tokens attends within itself and counts its
    positions from 0; a special token at either end attends to itself."""
    B, L = input_ids.shape
    special = torch.zeros((B, L), dtype=torch.bool, device=input_ids.device)
    for token in SPECIAL_TOKENS:
        special |= input_ids == token
    mask = torch.eye(L, dtype=torch.bool, device=input_ids.device).unsqueeze(0).repeat(B, 1, 1)
    position_ids = torch.zeros((B, L), dtype=torch.long, device=input_ids.device)
    previous = 0
    for row, col in special.nonzero().tolist():
        if col == 0 or col == L - 1:
            mask[row, col, col] = True
            position_ids[row, col] = 0
        else:
            mask[row, previous + 1:col + 1, previous + 1:col + 1] = True
            position_ids[row, previous + 1:col + 1] = torch.arange(
                0, col - previous, device=input_ids.device)
        previous = col
    return mask, position_ids


class BertEmbeddings(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.word_embeddings = nn.Embedding(config.vocab_size, config.hidden_size,
                                            padding_idx=config.pad_token_id)
        self.position_embeddings = nn.Embedding(config.max_position_embeddings, config.hidden_size)
        self.token_type_embeddings = nn.Embedding(config.type_vocab_size, config.hidden_size)
        self.LayerNorm = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps)

    def forward(self, input_ids, token_type_ids, position_ids):
        x = self.word_embeddings(input_ids) + self.token_type_embeddings(token_type_ids)
        x = x + self.position_embeddings(position_ids)
        return self.LayerNorm(x)


class BertSelfAttention(nn.Module):
    def __init__(self, config):
        super().__init__()
        if config.hidden_size % config.num_attention_heads:
            raise ValueError("num_attention_heads must divide hidden_size")
        self.num_attention_heads = config.num_attention_heads
        self.attention_head_size = config.hidden_size // config.num_attention_heads
        self.query = nn.Linear(config.hidden_size, config.hidden_size)
        self.key = nn.Linear(config.hidden_size, config.hidden_size)
        self.value = nn.Linear(config.hidden_size, config.hidden_size)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        B, L, C = x.shape
        shape = (B, L, self.num_attention_heads, self.attention_head_size)
        q = self.query(x).view(shape).transpose(1, 2)
        k = self.key(x).view(shape).transpose(1, 2)
        v = self.value(x).view(shape).transpose(1, 2)
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
        return out.transpose(1, 2).reshape(B, L, C)


class BertSelfOutput(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.dense = nn.Linear(config.hidden_size, config.hidden_size)
        self.LayerNorm = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps)

    def forward(self, x, residual):
        return self.LayerNorm(self.dense(x) + residual)


class BertAttention(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.self = BertSelfAttention(config)
        self.output = BertSelfOutput(config)

    def forward(self, x, bias):
        return self.output(self.self(x, bias), x)


class BertIntermediate(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.dense = nn.Linear(config.hidden_size, config.intermediate_size)
        self.intermediate_act_fn = activation(config.hidden_act)

    def forward(self, x):
        return self.intermediate_act_fn(self.dense(x))


class BertOutput(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.dense = nn.Linear(config.intermediate_size, config.hidden_size)
        self.LayerNorm = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps)

    def forward(self, x, residual):
        return self.LayerNorm(self.dense(x) + residual)


class BertLayer(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.attention = BertAttention(config)
        self.intermediate = BertIntermediate(config)
        self.output = BertOutput(config)

    def forward(self, x, bias):
        a = self.attention(x, bias)
        return self.output(self.intermediate(a), a)


class BertEncoder(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(config) for _ in range(config.num_hidden_layers))


class BertModel(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.embeddings = BertEmbeddings(config)
        self.encoder = BertEncoder(config)

    def forward(self, input_ids, attention_mask, token_type_ids, position_ids) -> torch.Tensor:
        """``attention_mask`` [B, L, L] bool (True: attend) → last hidden state [B, L, hidden]."""
        x = self.embeddings(input_ids, token_type_ids, position_ids)
        bias = (1.0 - attention_mask[:, None].to(x.dtype)) * torch.finfo(x.dtype).min
        for layer in self.encoder.layer:
            x = layer(x, bias)
        return x
