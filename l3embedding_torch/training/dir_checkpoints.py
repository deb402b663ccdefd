"""Directory checkpoints: one directory per snapshot, written and read by
``torch.distributed.checkpoint`` (the port's counterpart of
``l3embedding_tpu/training/orbax_io.py``, ``save_state_orbax`` /
``load_state_orbax``).

A snapshot holds ``{step, params, batch_stats, opt_state}`` in flax's
layout, the tree ``checkpoints.state_tree`` builds for a ``.ckpt``. The
on-disk layout is torch's (a ``.metadata`` file and ``__<rank>_0.distcp``
files), not orbax's: snapshots move between the two packages through
``.ckpt`` files (``checkpoints.save_state`` / ``load_state``).

Under a process group every rank must call ``save_state_dir``, as
``torch.distributed.checkpoint`` requires; the replicated state is written
once, shared among the ranks' files. A snapshot loads in any number of
processes, one included. No option of the train loop or of its CLI writes
these: the default checkpoint is the ``.ckpt``, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import warnings

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp

from .checkpoints import load_state_tree, state_tree


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _arrays(tree):
    if isinstance(tree, dict):
        return {k: _arrays(v) for k, v in tree.items()}
    return tree.numpy()


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


@contextlib.contextmanager
def _one_process_quietly():
    """torch warns on every call in one process that it assumes one process."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is disabled")
        yield


def save_state_dir(path: str, state) -> None:
    """Write {step, params, batch_stats, opt_state} of a TrainState as a
    directory at `path`, replacing one that is there. Under the default
    process group every rank takes part."""
    path = os.path.abspath(path)
    distributed = _distributed()
    if not distributed or dist.get_rank() == 0:
        if os.path.isdir(path):
            shutil.rmtree(path)
    if distributed:
        dist.barrier()
    with _one_process_quietly():
        dcp.save(_tensors(state_tree(state)), checkpoint_id=path, no_dist=not distributed)


def load_state_dir(path: str, state):
    """Restore a directory snapshot into `state`, a TrainState of the same
    model type, in place; returns it."""
    template = _tensors(state_tree(state))
    with _one_process_quietly():
        dcp.load(template, checkpoint_id=os.path.abspath(path), no_dist=not _distributed())
    return load_state_tree(_arrays(template), state)
