"""Training on several cards: one process per card in a
``torch.distributed`` process group, laid out as JAX's (data, model) mesh
(port of ``l3embedding_tpu/parallel``): data parallelism over the mesh's
``data`` axis, tensor parallelism (``tp.py``) over its ``model`` axis."""

from .distributed import (
    comm_device,
    data_group,
    initialize_distributed,
    local_device,
    local_rank,
    rank,
    world_size,
)
from .mesh import ProcessMesh, create_mesh, rank_grid, replicate, shard_batch, shard_batch_local

__all__ = [
    "ProcessMesh", "comm_device", "create_mesh", "data_group", "initialize_distributed", "local_device",
    "local_rank", "rank", "rank_grid", "replicate", "shard_batch", "shard_batch_local", "world_size",
]
