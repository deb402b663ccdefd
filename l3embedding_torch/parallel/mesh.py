"""Data-parallel placement in torch's terms (port of
``l3embedding_tpu/parallel/mesh.py``).

JAX replicates the state and splits each global batch over the mesh's
``data`` axis, device i holding rows ``[i·B/n, (i+1)·B/n)``
(``PartitionSpec("data")``). Here rank i of the process group is device i:
``replicate`` broadcasts rank 0's state to every rank, ``shard_batch``
takes this rank's rows of a global batch in that order, and
``shard_batch_local`` is the per-process form, where each process reads
only its own rows. The mesh's ``model`` axis (tensor parallelism,
``l3embedding_tpu/parallel/tp.py``) is not ported (``data_group``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .distributed import comm_device, rank, world_size

def _broadcast_(t: torch.Tensor, group) -> None:
    """Broadcast rank 0's `t` in place, through the collective's device."""
    dev = comm_device(group)
    if t.device == dev:
        dist.broadcast(t, src=0, group=group)
        return
    tmp = t.detach().to(dev)
    dist.broadcast(tmp, src=0, group=group)
    t.copy_(tmp)


def replicate(state, group=None):
    """Rank 0's parameters, buffers, Adam state and step on every rank, in
    place; → state. No-op without a group of more than one."""
    if group is None or dist.get_world_size(group) == 1:
        return state
    with torch.no_grad():
        for t in list(state.model.parameters()) + list(state.model.buffers()):
            _broadcast_(t.data, group)
        opt = state.optimizer
        have = torch.tensor([len(opt.state)], device=comm_device(group))
        counts = [torch.zeros_like(have) for _ in range(dist.get_world_size(group))]
        dist.all_gather(counts, have, group=group)
        if len({int(c) for c in counts}) != 1:
            raise RuntimeError(
                f"ranks hold Adam state for {[int(c) for c in counts]} parameters; "
                "restore the same checkpoint on every rank first"
            )
        for p in state.model.parameters():
            for t in opt.state.get(p, {}).values():
                if torch.is_tensor(t):
                    _broadcast_(t, group)
        step = torch.tensor([state.step], dtype=torch.int64, device=comm_device(group))
        dist.broadcast(step, src=0, group=group)
        state.step = int(step)
    return state


def shard_batch(batch: dict, group=None) -> dict:
    """This rank's rows of a global batch (every leaf's leading dimension
    split in equal blocks, rank i taking block i, as ``P("data")``); the
    whole batch without a group."""
    n = 1 if group is None else dist.get_world_size(group)
    if n == 1:
        return batch
    r = dist.get_rank(group)
    out = {}
    for k, x in batch.items():
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch leaf {k!r} of {b} rows not divisible by {n} ranks")
        out[k] = x[r * (b // n):(r + 1) * (b // n)]
    return out


def shard_batch_local(local_batch: dict, global_batch_size: int, group=None) -> dict:
    """The per-process form of ``shard_batch``: each rank passes only its own
    rows (``data_generator(shard_index=rank(), shard_count=world_size())``),
    global_batch_size // world of them; → the batch as it is, once every
    leaf is checked to have that many."""
    n = 1 if group is None else dist.get_world_size(group)
    if global_batch_size % n:
        raise ValueError(f"global batch {global_batch_size} not divisible by {n} ranks")
    want = global_batch_size // n
    for k, x in local_batch.items():
        if np.shape(x)[0] != want:
            raise ValueError(
                f"rank {rank()} of {world_size()}: batch leaf {k!r} has {np.shape(x)[0]} rows, "
                f"want {want} (global batch {global_batch_size})"
            )
    return local_batch
