"""SAM in plain PyTorch with ``transformers``' state-dict keys."""

from weaklysuperviseddl_tpu_torch.models.sam.model import SamModel  # noqa: F401
