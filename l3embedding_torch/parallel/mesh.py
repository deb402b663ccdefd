"""The (data, model) process mesh and data-parallel placement in torch's
terms (port of ``l3embedding_tpu/parallel/mesh.py``).

JAX lays its devices out as ``np.asarray(devices).reshape(data, model)``;
here rank r of the process group is device r, so rank ``d·M + m`` sits at
data index d and model index m (``rank_grid``). ``create_mesh(model_axis=M)``
builds that grid's process groups: the data group of a rank holds the ranks
of its model index (the batch is split over them), its model group the
ranks of its data index (tensor parallelism, ``parallel/tp.py``, splits the
widest layers over them).

JAX replicates the state and splits each global batch over the mesh's
``data`` axis, data index i holding rows ``[i·B/n, (i+1)·B/n)``
(``PartitionSpec("data")``): ``replicate`` broadcasts rank 0's state to
every rank, ``shard_batch`` takes this rank's rows of a global batch in
that order (the M ranks of one data index take the same rows), and
``shard_batch_local`` is the per-process form, where each process reads
only its own rows.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from .distributed import comm_device, rank, world_size


def rank_grid(n: int, model_axis: int = 1) -> np.ndarray:
    """The ranks of an n-process job as JAX's (data, model) device grid,
    ``arange(n).reshape(n // model_axis, model_axis)``."""
    if model_axis < 1 or n % model_axis:
        raise ValueError(f"{n} devices not divisible by model_axis={model_axis}")
    return np.arange(n).reshape(n // model_axis, model_axis)


@dataclass(frozen=True, eq=False)
class ProcessMesh:
    """This rank's place on the (data, model) grid and its two groups; a
    group is None where its axis has one rank (no collective runs there)."""

    data: int
    model: int
    data_index: int = 0
    model_index: int = 0
    data_group: object = None
    model_group: object = None


def create_mesh(model_axis: int = 1) -> ProcessMesh:
    """The job's (data, model) mesh, ``world // model_axis`` by
    ``model_axis`` (``rank_grid``). Every rank of the job calls it, as
    ``dist.new_group`` requires: each rank creates every group, data groups
    first, in one order. An axis that spans the whole job takes the job's
    group (no new group); in one process both groups are None."""
    n, r = world_size(), rank()
    grid = rank_grid(n, model_axis)
    data, model = grid.shape

    def mine(rows):
        out = None
        for ranks in rows:
            g = dist.new_group([int(x) for x in ranks])
            if r in ranks:
                out = g
        return out

    data_group = model_group = None
    if data > 1:
        data_group = dist.group.WORLD if model == 1 else mine(grid.T)
    if model > 1:
        model_group = dist.group.WORLD if data == 1 else mine(grid)
    return ProcessMesh(data, model, r // model, r % model, data_group, model_group)


def _data_axis(group) -> tuple[int, int]:
    """(ranks, this rank's index) along the batch's axis: a mesh's data
    axis, a group's ranks, or (1, 0) for None."""
    if isinstance(group, ProcessMesh):
        return group.data, group.data_index
    if group is None:
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


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
    """Rank 0's parameters, buffers, Adam state and step on every rank of
    `group` (a ProcessMesh: the whole job), in place; → state. No-op
    without a group of more than one. A tensor-parallel state is made from
    a replicated one (``tp.tp_shard_state``)."""
    if isinstance(group, ProcessMesh):
        group = dist.group.WORLD if group.data * group.model > 1 else None
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
    split in equal blocks over the data axis of `group`, a process group or
    a ProcessMesh, data index i taking block i, as ``P("data")``); the whole
    batch without a group."""
    n, r = _data_axis(group)
    if n == 1:
        return batch
    out = {}
    for k, x in batch.items():
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch leaf {k!r} of {b} rows not divisible by {n} ranks")
        out[k] = x[r * (b // n):(r + 1) * (b // n)]
    return out


def shard_batch_local(local_batch: dict, global_batch_size: int, group=None) -> dict:
    """The per-process form of ``shard_batch``: each rank passes only its own
    rows (``data_generator(shard_index=data index, shard_count=data
    ranks)``), global_batch_size // data ranks of them; → the batch as it
    is, once every leaf is checked to have that many."""
    n, _ = _data_axis(group)
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
