"""GroundingDINO in plain PyTorch with ``transformers``' state-dict keys."""

from weaklysuperviseddl_tpu_torch.models.gdino.model import (  # noqa: F401
    GroundingDinoForObjectDetection,
)
