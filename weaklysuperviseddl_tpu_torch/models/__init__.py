"""models of the PyTorch port (counterpart of weaklysuperviseddl_tpu.models)."""

from weaklysuperviseddl_tpu_torch.models.basnet import BASNet  # noqa: F401
