from deepblast_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    initialize_distributed,
    make_mesh,
    param_partition_spec,
    replicated_sharding,
    shard_batch,
    shard_params,
)
