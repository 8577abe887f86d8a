"""Reference surface: FullySupervisedModel/SupervisedModel.py (port of
weaklysuperviseddl_tpu/compat/SupervisedModel.py)."""

from __future__ import annotations

from weaklysuperviseddl_tpu_torch.compat.SegmentationModel import initialize_model  # noqa: F401
from weaklysuperviseddl_tpu_torch.config import DataConfig, ExperimentConfig, SegConfig
from weaklysuperviseddl_tpu_torch.pipelines.supervised import run_supervised_training as _run


def run_supervised_training(data_path: str | None = "./data", num_epochs: int = 10,
                            batch_size: int = 16, train_ratio: float = 0.85,
                            num_classes: int = 2, lr: float = 1e-4, device=None, **kwargs):
    """Reference signature (SupervisedModel.py:85-123), on ``device`` (None:
    the card); of ``kwargs`` only ``backbone_depth`` and ``width_multiplier``
    are read. Returns ``pipelines.supervised.run_supervised_training``'s
    (state, metrics)."""
    cfg = ExperimentConfig(
        data=DataConfig(root=data_path, batch_size=batch_size),
        seg=SegConfig(num_classes=num_classes, lr=lr, batch_size=batch_size,
                      **{k: v for k, v in kwargs.items()
                         if k in ("backbone_depth", "width_multiplier")}))
    return _run(cfg, num_epochs=num_epochs, train_ratio=train_ratio, device=device)
