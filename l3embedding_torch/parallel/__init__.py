"""Data-parallel training on several cards: one process per card in a
``torch.distributed`` process group (port of ``l3embedding_tpu/parallel``,
without its tensor-parallel ``model`` axis)."""

from .distributed import (
    comm_device,
    data_group,
    initialize_distributed,
    local_device,
    local_rank,
    rank,
    world_size,
)
from .mesh import replicate, shard_batch, shard_batch_local

__all__ = [
    "comm_device", "data_group", "initialize_distributed", "local_device",
    "local_rank", "rank", "replicate", "shard_batch", "shard_batch_local", "world_size",
]
