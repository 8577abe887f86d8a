"""One config layer for every entry point (port of weaklysuperviseddl_tpu/config.py).

The same dataclasses with the same field names and defaults as the JAX
package, so a config recorded by either package loads in the other.
``MeshConfig`` places a run on a ('data', 'model') mesh as in JAX
(``parallel/mesh.mesh_from_config``). ``RefineConfig.use_pallas``
keeps its name: in the port it selects the CUDA kernel. ``classifier.dtype``
and ``seg.dtype`` are the models' compute dtypes, "float32", "bfloat16" or
"float16" (any other raises here).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

COMPUTE_DTYPES = ("float32", "bfloat16", "float16")


def check_compute_dtype(field: str, value) -> str:
    """``value`` if it names a compute dtype the port runs, else raise (the
    JAX package takes any ``jnp.dtype``; its float16, bfloat16 and float32
    are the ones it runs models in)."""
    if value not in COMPUTE_DTYPES:
        raise ValueError(f"{field}={value!r} is not ported: the port computes in "
                         f"{', '.join(COMPUTE_DTYPES)}")
    return value


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Oxford-IIIT-Pet-style data (ref ExtraUtilities.py:24-63,
    AlternatingDirectionCutLoss.py:11-29)."""

    root: str | None = None          # Pet dataset root; None => synthetic data
    image_size: int = 224
    seg_size: int = 256              # PseudoSegmentationDataset resize (ref SegmentationDataset.py:20)
    num_classes: int = 37
    train_ratio: float = 0.8         # ref ExtraUtilities.py:43
    batch_size: int = 32
    eval_batch_size: int = 8
    interpolation: str = "bilinear"  # 'bilinear' (train variant) | 'bicubic' (eval variant)
    shift_mask_labels: bool = True   # (trimap - 1).clamp(0): ref AlternatingDirectionCutLoss.py:19
    normalize: bool = False
    seed: int = 0
    synthetic_size: int = 128        # number of synthetic samples when root is None


@dataclasses.dataclass(frozen=True)
class ClassifierConfig:
    """Frozen-ResNet50 CAM classifier (ref ClassificationModel.py:9-41)."""

    num_classes: int = 37
    dilate_layer4: bool = True       # replace_stride_with_dilation=[False, False, True]
    lr: float = 1e-3                 # Adam on fc only (ref ClassificationModel.py:72)
    epochs: int = 10
    dtype: str = "float32"
    depth: int = 50
    width_multiplier: float = 1.0

    def __post_init__(self):
        check_compute_dtype("classifier.dtype", self.dtype)


@dataclasses.dataclass(frozen=True)
class CamConfig:
    """LayerCAM extraction (ref LayerCAM.py:7-81, AlternatingDirectionCutLoss.py:216-318)."""

    target_layers: Sequence[str] = ("layer3", "layer4")
    alpha: float = 1.0
    # 'final': normalise once per layer, mean over layers, clamp(0)**alpha
    # 'per_layer': normalise -> **alpha -> renormalise per layer, then mean
    alpha_mode: str = "per_layer"
    output_size: int = 224


@dataclasses.dataclass(frozen=True)
class MaskConfig:
    """Pseudo-mask generation (ref PsuedoMasks.py:23-79)."""

    cam_thresh: float = 0.3
    keep_largest: bool = True
    use_crf: bool = False            # AlternatingDirectionCutLoss.py:558 path uses CRF, PsuedoMasks.py does not
    # bilateral backend (masks/densecrf.py): "subsampled" = full-resolution
    # queries x the stride-`crf_key_stride` key subgrid through the exact
    # filter; "attention" = the exact O(N^2) filter. The JAX package's "grid",
    # "lattice" and "rff" are not ported yet.
    crf_backend: str = "subsampled"
    crf_key_stride: int = 2
    crf_iters: int = 5
    crf_gaussian_sxy: float = 1.0
    crf_gaussian_compat: float = 2.0
    crf_bilateral_sxy: float = 50.0
    crf_bilateral_srgb: float = 5.0
    crf_bilateral_compat: float = 10.0
    max_images: int = 500            # ref PsuedoMasks.py:49 cap
    store_dir: str | None = None     # None => in-memory store


@dataclasses.dataclass(frozen=True)
class SegConfig:
    """DeepLabV3 segmentation training (ref SegmentationModel.py:59-122)."""

    num_classes: int = 2
    lr: float = 1e-4
    epochs: int = 5
    batch_size: int = 4
    loss_fn: str = "cross_entropy"   # 'cross_entropy' | 'lovasz_softmax'
    dtype: str = "float32"
    backbone_depth: int = 50
    width_multiplier: float = 1.0
    output_stride: int = 8
    bn_frozen: bool = False

    def __post_init__(self):
        check_compute_dtype("seg.dtype", self.dtype)


@dataclasses.dataclass(frozen=True)
class RefineConfig:
    """Alternating-direction mask refinement (ref AlternatingDirectionCutLoss.py:709-767)."""

    lambda_boundary: float = 0.1
    threshold: float = 0.5
    lr: float = 1e-2
    num_steps: int = 20
    sigma_color: float = 0.1
    sigma_space: float = 5.0
    window_size: int = 5
    loss: str = "ncut"               # 'ncut' | 'boundary'
    use_pallas: bool = True          # the port: CUDA kernel (True) vs plain PyTorch


@dataclasses.dataclass(frozen=True)
class AlternatingConfig:
    """Outer alternating train<->refine loop (ref AlternatingDirectionCutLoss.py:791-818)."""

    num_alternations: int = 10
    epochs_per_round: int = 10
    refine_repeats: int = 5          # ref :803 'for repeated in range(5)'
    refine: RefineConfig = dataclasses.field(default_factory=RefineConfig)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The ('data', 'model') mesh: batch on 'data', conv output channels on
    'model' (one process per device)."""

    data: int = -1                   # -1 => all devices on the data axis
    model: int = 1


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    classifier: ClassifierConfig = dataclasses.field(default_factory=ClassifierConfig)
    cam: CamConfig = dataclasses.field(default_factory=CamConfig)
    mask: MaskConfig = dataclasses.field(default_factory=MaskConfig)
    seg: SegConfig = dataclasses.field(default_factory=SegConfig)
    alternating: AlternatingConfig = dataclasses.field(default_factory=AlternatingConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    seed: int = 0


def smoke_config() -> ExperimentConfig:
    """Tiny config used by tests and smoke runs."""
    return ExperimentConfig(
        data=DataConfig(image_size=64, seg_size=64, batch_size=4, synthetic_size=16),
        classifier=ClassifierConfig(depth=18, width_multiplier=0.25, epochs=1),
        cam=CamConfig(output_size=64),
        mask=MaskConfig(max_images=16),
        seg=SegConfig(epochs=1, batch_size=4, width_multiplier=0.25, backbone_depth=18),
        alternating=AlternatingConfig(
            num_alternations=1, epochs_per_round=1, refine_repeats=1,
            refine=RefineConfig(num_steps=2),
        ),
    )


def apply_overrides(cfg, overrides: dict):
    """Apply {'data.image_size': '224', ...} onto nested frozen dataclasses, at
    any depth ('alternating.refine.num_steps' reaches the RefineConfig inside
    AlternatingConfig). String values are coerced to the field's type."""

    def coerce(current, raw):
        if isinstance(current, bool):
            return raw.lower() in ("1", "true", "yes")
        if current is None:
            return raw
        if isinstance(current, (int, float, str)):
            return type(current)(raw)
        return raw

    def set_path(node, path: list[str], raw):
        field, rest = path[0], path[1:]
        current = getattr(node, field)
        value = set_path(current, rest, raw) if rest else coerce(current, raw)
        return dataclasses.replace(node, **{field: value})

    for key, raw in overrides.items():
        cfg = set_path(cfg, key.split("."), raw)
    return cfg
