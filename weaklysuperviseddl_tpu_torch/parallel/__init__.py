"""The ('data', 'model') mesh of the port (counterpart of weaklysuperviseddl_tpu.parallel)."""

from weaklysuperviseddl_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    make_mesh,
    replicated,
    shard_batch,
)
