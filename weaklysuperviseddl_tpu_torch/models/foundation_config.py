"""Configurations of the foundation baseline's two models: SAM and GroundingDINO.

The fields are the ones the port's models read, with ``transformers``' names
and defaults, so a ``config.json`` (or a ``transformers`` config's
``to_dict()``) reads into them unchanged (``from_dict`` ignores the keys the
models do not read). Presets:

- ``tiny_sam_config``, ``tiny_gdino_config``, ``tiny_gdino_vocab``: the JAX
  package's download-free test models (its ``pipelines/foundation.py``).
- ``sam_vit_base``: ``SamConfig()``'s field values, which are facebook/sam-vit-base's.
- ``grounding_dino_base``: IDEA-Research/grounding-dino-base, a Swin-B (384)
  backbone and a BERT-base text encoder, processor sizes 800/1333.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


def _from_dict(cls, d: dict | None, **nested):
    d = dict(d or {})
    for name, sub in nested.items():
        d[name] = sub.from_dict(d.get(name))
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in names})


class _Config:
    @classmethod
    def from_dict(cls, d: dict | None = None):
        return _from_dict(cls, d)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


# --------------------------------------------------------------------------- SAM

@dataclass
class SamVisionConfig(_Config):
    hidden_size: int = 768
    output_channels: int = 256
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    num_channels: int = 3
    image_size: int = 1024
    patch_size: int = 16
    hidden_act: str = "gelu"
    layer_norm_eps: float = 1e-6
    qkv_bias: bool = True
    mlp_ratio: float = 4.0
    use_abs_pos: bool = True
    use_rel_pos: bool = True
    window_size: int = 14
    global_attn_indexes: list = field(default_factory=lambda: [2, 5, 8, 11])
    num_pos_feats: int = 128
    mlp_dim: int | None = None

    def __post_init__(self):
        if self.mlp_dim is None:
            self.mlp_dim = int(self.hidden_size * self.mlp_ratio)


@dataclass
class SamPromptEncoderConfig(_Config):
    hidden_size: int = 256
    image_size: int = 1024
    patch_size: int = 16
    mask_input_channels: int = 16
    num_point_embeddings: int = 4
    hidden_act: str = "gelu"
    layer_norm_eps: float = 1e-6

    @property
    def image_embedding_size(self) -> int:
        return self.image_size // self.patch_size


@dataclass
class SamMaskDecoderConfig(_Config):
    hidden_size: int = 256
    hidden_act: str = "relu"
    mlp_dim: int = 2048
    num_hidden_layers: int = 2
    num_attention_heads: int = 8
    attention_downsample_rate: int = 2
    num_multimask_outputs: int = 3
    iou_head_depth: int = 3
    iou_head_hidden_dim: int = 256
    layer_norm_eps: float = 1e-6


@dataclass
class SamConfig(_Config):
    vision_config: SamVisionConfig = field(default_factory=SamVisionConfig)
    prompt_encoder_config: SamPromptEncoderConfig = field(default_factory=SamPromptEncoderConfig)
    mask_decoder_config: SamMaskDecoderConfig = field(default_factory=SamMaskDecoderConfig)

    @classmethod
    def from_dict(cls, d: dict | None = None):
        return _from_dict(cls, d, vision_config=SamVisionConfig,
                          prompt_encoder_config=SamPromptEncoderConfig,
                          mask_decoder_config=SamMaskDecoderConfig)


# ----------------------------------------------------------------- GroundingDINO

@dataclass
class SwinConfig(_Config):
    image_size: int = 224
    patch_size: int = 4
    num_channels: int = 3
    embed_dim: int = 96
    depths: list = field(default_factory=lambda: [2, 2, 6, 2])
    num_heads: list = field(default_factory=lambda: [3, 6, 12, 24])
    window_size: int = 7
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    hidden_act: str = "gelu"
    layer_norm_eps: float = 1e-5
    use_absolute_embeddings: bool = False
    out_indices: list = field(default_factory=lambda: [2, 3, 4])

    def __post_init__(self):
        if self.use_absolute_embeddings:
            raise ValueError("the port's Swin backbone has no absolute position embeddings "
                             "(GroundingDINO's backbones use none)")


@dataclass
class BertConfig(_Config):
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0
    position_embedding_type: str = "absolute"

    def __post_init__(self):
        if self.position_embedding_type != "absolute":
            raise ValueError(f"position_embedding_type {self.position_embedding_type!r}: the "
                             "port's BERT has absolute position embeddings only")


@dataclass
class GroundingDinoConfig(_Config):
    backbone_config: SwinConfig = field(default_factory=SwinConfig)
    text_config: BertConfig = field(default_factory=BertConfig)
    num_queries: int = 900
    d_model: int = 256
    encoder_ffn_dim: int = 2048
    encoder_layers: int = 6
    encoder_attention_heads: int = 8
    decoder_ffn_dim: int = 2048
    decoder_layers: int = 6
    decoder_attention_heads: int = 8
    activation_function: str = "relu"
    position_embedding_type: str = "sine"
    num_feature_levels: int = 4
    encoder_n_points: int = 4
    decoder_n_points: int = 4
    two_stage: bool = True
    max_text_len: int = 256
    embedding_init_target: bool = True
    query_dim: int = 4
    decoder_bbox_embed_share: bool = True
    two_stage_bbox_embed_share: bool = False
    positional_embedding_temperature: float = 20
    layer_norm_eps: float = 1e-5
    use_timm_backbone: bool = False
    # The image processor's size ({"shortest_edge", "longest_edge"}); None is
    # the JAX package's rule for a model built from a config: both edges at
    # the backbone's image_size.
    processor_size: dict | None = None

    def __post_init__(self):
        unsupported = {
            "two_stage": not self.two_stage,
            "embedding_init_target": not self.embedding_init_target,
            "two_stage_bbox_embed_share": self.two_stage_bbox_embed_share,
            "position_embedding_type": self.position_embedding_type != "sine",
            "use_timm_backbone": self.use_timm_backbone,
            "query_dim": self.query_dim != 4,
        }
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise ValueError(f"GroundingDINO variant not in the port: {bad} (the port holds "
                             "the two-stage, sine-embedded, Swin-backed model of the published "
                             "checkpoints)")

    @classmethod
    def from_dict(cls, d: dict | None = None):
        return _from_dict(cls, d, backbone_config=SwinConfig, text_config=BertConfig)

    @property
    def image_processor_size(self) -> dict:
        if self.processor_size is not None:
            return dict(self.processor_size)
        s = self.backbone_config.image_size
        return {"shortest_edge": s, "longest_edge": s}


# ---------------------------------------------------------------------- presets

def tiny_gdino_vocab() -> list[str]:
    """Minimal WordPiece vocab covering the reference prompts ("a cat", "a dog")."""
    return ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
            "a", "cat", "dog", ".", "an", "animal"]


def tiny_gdino_config() -> GroundingDinoConfig:
    """The JAX package's smallest GroundingDINO: tiny Swin, 2-layer BERT over
    ``tiny_gdino_vocab``, one encoder and one decoder layer."""
    text = BertConfig(vocab_size=len(tiny_gdino_vocab()), hidden_size=64,
                      num_hidden_layers=2, num_attention_heads=2,
                      intermediate_size=128, max_position_embeddings=64)
    backbone = SwinConfig(image_size=224, embed_dim=16, depths=[1, 1, 1],
                          num_heads=[1, 1, 1], out_indices=[2, 3])
    return GroundingDinoConfig(
        text_config=text, backbone_config=backbone,
        d_model=64, encoder_layers=1, decoder_layers=1,
        encoder_attention_heads=2, decoder_attention_heads=2,
        encoder_ffn_dim=128, decoder_ffn_dim=128,
        num_queries=20, num_feature_levels=2)


def tiny_sam_config() -> SamConfig:
    """The JAX package's smallest SAM: 2 ViT layers at 256², default widths."""
    return SamConfig(vision_config=SamVisionConfig(num_hidden_layers=2, image_size=256,
                                                   global_attn_indexes=[1]),
                     prompt_encoder_config=SamPromptEncoderConfig(image_size=256))


def sam_vit_base() -> SamConfig:
    """facebook/sam-vit-base: ViT-B (768 wide, 12 layers, 12 heads) at 1024²,
    window 14, global attention at [2, 5, 8, 11], neck 256."""
    return SamConfig()


def grounding_dino_base() -> GroundingDinoConfig:
    """IDEA-Research/grounding-dino-base: Swin-B at 384 (embed 128, depths
    [2, 2, 18, 2], heads [4, 8, 16, 32], window 12, out_indices [2, 3, 4]),
    BERT-base, d_model 256, 900 queries, 6 + 6 layers, 4 levels, 4 points,
    processor sizes 800/1333."""
    backbone = SwinConfig(image_size=384, embed_dim=128, depths=[2, 2, 18, 2],
                          num_heads=[4, 8, 16, 32], window_size=12, out_indices=[2, 3, 4])
    return GroundingDinoConfig(backbone_config=backbone,
                               processor_size={"shortest_edge": 800, "longest_edge": 1333})
