"""Several devices: the mesh and its sharding rules, and the token-sharded
(sequence-parallel) encoder."""

from sam_road_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    make_mesh,
    on_device,
    replicate,
    replicated_sharding,
    shard_batch,
)

__all__ = ["Mesh", "make_mesh", "on_device", "batch_sharding", "replicate",
           "replicated_sharding", "shard_batch"]
