from .mesh import (
    batch_shardings,
    current_mesh,
    init_distributed,
    make_mesh,
    param_shardings,
    replicate,
    replicated,
    shard_batch,
    shard_params,
    use_mesh,
)

__all__ = [
    "batch_shardings",
    "current_mesh",
    "init_distributed",
    "make_mesh",
    "param_shardings",
    "replicate",
    "replicated",
    "shard_batch",
    "shard_params",
    "use_mesh",
]
