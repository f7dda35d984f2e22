"""Multi-device runs on ``torch.distributed`` (``ganspace_tpu/parallel``)."""

from ganspace_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    current_mesh,
    feature_sharding,
    get_mesh,
    launch,
    pipeline_mesh,
    replicated,
    reshard_for_estimator,
    shard_batch,
)

__all__ = [
    "get_mesh",
    "pipeline_mesh",
    "reshard_for_estimator",
    "shard_batch",
    "batch_sharding",
    "feature_sharding",
    "replicated",
    "Mesh",
    "current_mesh",
    "launch",
]
