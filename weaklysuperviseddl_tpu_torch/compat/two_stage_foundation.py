"""Reference surface: FoundationModel/two_stage_foundation.py (port of
weaklysuperviseddl_tpu/compat/two_stage_foundation.py).

The module-global models of the reference become a pipeline built on first
use from the local Hugging Face cache (``pipelines/foundation.py``), on the
card.
"""

from __future__ import annotations

from weaklysuperviseddl_tpu_torch.compat.Visualisation import plot_segmentation  # noqa: F401
from weaklysuperviseddl_tpu_torch.pipelines.foundation import (  # noqa: F401
    DEFAULT_PROMPTS,
    FoundationPipeline,
    calculate_iou_and_accuracy,
    convert_3channel_to_mask,
)

_default_pipeline = None


def _pipeline():
    global _default_pipeline
    if _default_pipeline is None:
        _default_pipeline = FoundationPipeline()  # the hub snapshots, on the card
    return _default_pipeline


def run_segmentation_pipeline(image_pil, prompts=("a cat", "a dog")):
    """Reference :44-74 (module-global models → lazily-built pipeline)."""
    return _pipeline().run_segmentation_pipeline(image_pil, prompts)


def evaluate_pipeline_on_dataset(dataset, num_images=100, save_outputs=True,
                                 save_dir="pseudo_masks", pipeline=None, log=print):
    """Reference :99-149."""
    from weaklysuperviseddl_tpu_torch.pipelines.foundation import (
        evaluate_pipeline_on_dataset as _eval,
    )

    return _eval(dataset, pipeline or _pipeline(), num_images=num_images,
                 save_outputs=save_outputs, save_dir=save_dir, log=log)
