"""Process-group set-up for training on several cards (port of
``l3embedding_tpu/parallel/distributed.py``).

JAX drives every device of a host from one process; the port runs one
process per card, as ``python -m torch.distributed.run --nproc-per-node N``
launches them, and joins them in a ``torch.distributed`` process group.
``initialize_distributed`` reads its explicit arguments first, then the
launcher's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``); in a single process it does nothing and
returns False, as JAX's does.

The backend is NCCL when every rank of the host has a card of its own, and
gloo otherwise: on the CPU, and when several ranks share one card (NCCL
refuses two ranks on one GPU; gloo all-reduces CUDA tensors through the
host).
"""

from __future__ import annotations

import logging
import os

import torch
import torch.distributed as dist

LOGGER = logging.getLogger("l3embedding_torch.parallel")


def _env_int(name: str) -> int | None:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else None


def local_rank() -> int:
    """This process's index among the ranks of its host (``LOCAL_RANK``,
    0 without a launcher)."""
    return _env_int("LOCAL_RANK") or 0


def default_backend(local_ranks: int) -> str:
    """NCCL when each of this host's `local_ranks` ranks has a card of its
    own, else gloo."""
    if torch.cuda.is_available() and local_ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize_distributed(
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    backend: str | None = None,
) -> bool:
    """Join this process to the job's process group; → True when a group of
    more than one process was formed (or already exists), False in a single
    process.

    init_method: a ``tcp://host:port`` or ``file://`` URL; default
      ``env://`` (``MASTER_ADDR`` / ``MASTER_PORT``) when the launcher set
      them.
    backend: default ``default_backend`` of this host's ranks
      (``LOCAL_WORLD_SIZE``; without it, every rank is taken to be on this
      host). Under NCCL the rank's card is made current first
      (``local_device()``).
    """
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size() > 1
    if world_size is None:
        world_size = _env_int("WORLD_SIZE")
    if rank is None:
        rank = _env_int("RANK")
    if world_size is None or world_size <= 1:
        return False
    if rank is None:
        raise ValueError(f"a {world_size}-process job needs this process's rank (RANK)")
    if init_method is None:
        if not (os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT")):
            raise ValueError(
                f"a {world_size}-process job needs init_method or MASTER_ADDR and MASTER_PORT"
            )
        init_method = "env://"
    if not dist.is_available():
        raise RuntimeError("this PyTorch build has no torch.distributed")
    if backend is None:
        backend = default_backend(_env_int("LOCAL_WORLD_SIZE") or world_size)
    if backend == "nccl":
        torch.cuda.set_device(local_device())
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
    LOGGER.info("process group initialised (%s): rank %d of %d", backend, rank, world_size)
    return True


def world_size() -> int:
    """Processes in the job's group; 1 without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def rank() -> int:
    """This process's rank; 0 without a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def data_group(model_axis: int = 1):
    """The group the data-parallel steps reduce over: the data group of
    ``create_mesh(model_axis)`` (the whole job at model_axis=1, with no new
    group), or None when the data axis has one rank (one process, or every
    rank on the model axis). With model_axis > 1 every rank calls it, as
    ``create_mesh``."""
    from .mesh import create_mesh

    return create_mesh(model_axis).data_group


def local_device(device: str | torch.device = "cuda") -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` (ranks that outnumber the
    host's cards share them in turn, under gloo), or the CPU only when
    `device` asks for it. A device with an index is returned as it is."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to train on the CPU")
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def comm_device(group=None) -> torch.device:
    """Where the group's collectives take their tensors: the current card
    under NCCL, the CPU under gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")
