"""pipelines of the PyTorch port (counterpart of weaklysuperviseddl_tpu.pipelines)."""

from weaklysuperviseddl_tpu_torch.pipelines.weakly import (  # noqa: F401
    run_weakly_supervised,
    run_weakly_supervised_alternating,
)
from weaklysuperviseddl_tpu_torch.pipelines.supervised import run_supervised_training  # noqa: F401
from weaklysuperviseddl_tpu_torch.pipelines.ablations import (  # noqa: F401
    run_ablation,
    run_ablation_experiment,
)
