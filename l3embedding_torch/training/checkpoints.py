"""Checkpoints in the JAX package's format, without flax (port of
``l3embedding_tpu/training/checkpoints.py``).

A ``.ckpt`` is a flax msgpack state dict: nested maps of string keys,
sorted at every level (as ``jax.tree.map`` leaves them before flax packs
them), whose array leaves are msgpack ext type 1 holding a msgpack
``(shape, dtype name, raw bytes)`` triple in C order. This module writes
and reads that format with ``msgpack`` alone, so a file the port writes
restores through the JAX package's ``load_state`` / ``load_variables``
and the other way round, bit for bit.

Four roles per run with the JAX package's file names, plus the mid-epoch
preemption snapshot; ``save_state`` / ``load_state`` hold ``{step,
params, batch_stats, opt_state}`` of a ``TrainState`` (the optimiser state
in optax.adam's layout, ``compat/to_jax.py``), ``save_variables`` the
weights alone. Files appear atomically (tmp + rename). Under data
parallelism the state is replicated and the chief (rank 0) writes it;
``load_state`` reads the file on every rank, so a checkpoint does not
depend on how many ranks wrote or read it. Under tensor parallelism
(``parallel/tp.py``) ``state_tree`` gathers the split leaves over the
model group, so every rank calls ``save_state`` / ``save_variables`` and
the chief writes the whole tree; loading keeps this rank's slices.
"""

from __future__ import annotations

import os
import queue
import threading

import msgpack
import numpy as np
import torch

from ..compat.from_jax import adam_from_jax, avc_from_jax_variables
from ..compat.to_jax import adam_to_jax, avc_to_jax_variables
from ..parallel.distributed import rank
from ..parallel.tp import gather_tree, slice_tree, tp_mesh

LATEST = "model_latest.ckpt"
BEST_VALID_ACC = "model_best_valid_accuracy.ckpt"
BEST_VALID_LOSS = "model_best_valid_loss.ckpt"
PERIODIC_FMT = "model_checkpoint.{epoch:02d}.ckpt"
# Mid-epoch preemption snapshots get their own file so LATEST always holds
# epoch-boundary state.
PREEMPT = "model_preempt.ckpt"

_EXT_NDARRAY = 1


def _ndarray(data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    dtype = np.dtype(dtype_name.decode() if isinstance(dtype_name, bytes) else dtype_name)
    return np.frombuffer(buffer, dtype=dtype).reshape(shape, order="C")


def _ext_hook(code: int, data: bytes):
    if code != _EXT_NDARRAY:
        raise ValueError(f"unexpected msgpack ext type {code} in a checkpoint")
    return _ndarray(data)


def _ext_pack(x):
    if isinstance(x, np.ndarray):
        if x.dtype.hasobject or x.dtype.isalignedstruct:
            raise ValueError(f"cannot serialise an array of dtype {x.dtype}")
        if x.nbytes > 2**30:
            raise ValueError("arrays over 1 GiB are chunked by flax; not supported")
        blob = msgpack.packb((x.shape, x.dtype.name, x.tobytes("C")), use_bin_type=True)
        return msgpack.ExtType(_EXT_NDARRAY, blob)
    raise TypeError(f"cannot serialise {type(x).__name__} in a checkpoint")


def _sorted(tree):
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def to_bytes(tree: dict) -> bytes:
    """Nested dicts of numpy arrays → flax msgpack bytes."""
    return msgpack.packb(_sorted(tree), default=_ext_pack, strict_types=True)


def _check_unchunked(tree) -> None:
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            raise ValueError("chunked (> 1 GiB) array leaves are not supported")
        for v in tree.values():
            _check_unchunked(v)


def read_tree(path: str) -> dict:
    """A ``.ckpt`` → nested dicts of (read-only) numpy arrays."""
    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False)
    _check_unchunked(tree)
    return tree


def load_variables(path: str) -> dict:
    """→ {"params": ..., "batch_stats": ...} as nested dicts of numpy arrays
    (a weights file or a whole training state)."""
    tree = read_tree(path)
    return {"params": tree["params"], "batch_stats": tree["batch_stats"]}


def _write_atomic(path: str, blob: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)


def state_tree(state) -> dict:
    """A TrainState → host copies {step, params, batch_stats, opt_state} in
    flax's layout, whole: the split leaves of a tensor-parallel state are
    gathered over its model group, whose every rank calls this. The copies
    are taken now: the next step updates the model and the optimiser in
    place."""
    variables = avc_to_jax_variables(state.model, state.model_type)
    return gather_tree({
        "step": np.asarray(state.step, np.int32),
        "params": variables["params"],
        "batch_stats": variables["batch_stats"],
        "opt_state": adam_to_jax(state.model, state.model_type, state.optimizer),
    }, tp_mesh(state.model))


def _writes(model) -> bool:
    """A tensor-parallel model's tree is written by the job's chief alone."""
    return tp_mesh(model) is None or rank() == 0


def save_state(path: str, state) -> None:
    """Atomically write {step, params, batch_stats, opt_state}. Under
    tensor parallelism every rank calls it and rank 0 writes."""
    tree = state_tree(state)
    if _writes(state.model):
        _write_atomic(path, to_bytes(tree))


def load_state(path: str, state):
    """Restore a ``.ckpt`` (written by either package) into `state`, a
    TrainState of the same model type (from ``create_train_state``), in
    place; returns it."""
    return load_state_tree(read_tree(path), state)


def load_state_tree(tree: dict, state):
    """Put {step, params, batch_stats, opt_state} in flax's layout (as
    ``state_tree`` makes it) into `state`, in place (this rank's slices of
    the split leaves, for a tensor-parallel state); returns it."""
    model = state.model
    tree = slice_tree(tree, tp_mesh(model))
    device = next(model.parameters()).device
    sd = avc_from_jax_variables(tree, state.model_type)
    model.load_state_dict({k: v.to(device) for k, v in sd.items()})
    adam_from_jax(tree["opt_state"], model, state.model_type, state.optimizer)
    state.step = int(np.asarray(tree["step"]))
    return state


def save_tree(path: str, tree: dict) -> None:
    """Atomically write nested dicts of numpy arrays as a ``.ckpt`` (the
    JAX package's ``save_variables(path, params, batch_stats)`` for
    ``{"params": params, "batch_stats": batch_stats}``)."""
    _write_atomic(path, to_bytes(tree))


def save_variables(path: str, model: torch.nn.Module, model_type: str) -> None:
    """Weights-only snapshot {params, batch_stats} (for extraction); under
    tensor parallelism every rank calls it and rank 0 writes."""
    tree = gather_tree(avc_to_jax_variables(model, model_type), tp_mesh(model))
    if _writes(model):
        save_tree(path, tree)


class AsyncCheckpointWriter:
    """Overlaps checkpoint encoding and disk writes with training.

    save() copies the state to host memory before it returns, which the
    port needs for correctness: the next train step updates the model and
    the optimiser in place. The msgpack encode and the atomic write run on
    one background thread, in submission order, so ``model_latest.ckpt``
    never goes backwards. A failed write re-raises on the next
    save()/flush()/close(). Use as a context manager or call close().
    """

    def __init__(self, max_pending: int = 4):
        self._q: queue.Queue = queue.Queue(maxsize=max_pending)
        self._exc: BaseException | None = None
        self._closed = False
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                path, host_tree = item
                try:
                    _write_atomic(path, to_bytes(host_tree))
                except BaseException as e:  # surfaced on the next save/flush/close
                    self._exc = e
            finally:
                self._q.task_done()

    def _check(self):
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc

    def save(self, path: str, state) -> None:
        if self._closed:
            raise RuntimeError("AsyncCheckpointWriter is closed")
        self._check()
        self._q.put((path, state_tree(state)))

    def flush(self) -> None:
        """Block until every queued write is on disk. Call before publishing
        metadata that implies the checkpoint exists (the epoch's history
        row, removing preempt.json)."""
        self._q.join()
        self._check()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._q.put(None)
        self._thread.join()
        self._check()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc and exc[0] is not None:
            # Don't mask the exception in flight with a write error.
            try:
                self.close()
            except Exception:
                pass
            return False
        self.close()
        return False
