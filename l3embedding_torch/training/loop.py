"""AVC training — the port's ``03_train_embedding`` (port of
``l3embedding_tpu/training/loop.py``, reference l3embedding/train.py:218-421).

The same experiment surface as the JAX package's ``train()``: model_id
from the data dir's name, a timestamped run dir, ``config.json``,
``model.json``, ``history_csvlog.csv``, the history pickles, the four
checkpoint roles each epoch (``.ckpt`` files the JAX package restores),
resume through ``continue_model_dir`` at an epoch boundary or, after a
preemption, at the exact step.

One process drives one device (``device``, "cuda" by default). Under a
process group of several ranks (``parallel.initialize_distributed``, one
process per card as ``torch.distributed.run`` starts them) the run is
data parallel: each rank trains on ``cuda:LOCAL_RANK`` with its own shard
of the corpus and global_batch // world rows a step, the ranks agree on
one run directory and stop together on preemption, and only rank 0 (the
chief) writes. ``gpus`` is recorded and, as in the JAX package, advisory:
the parallelism follows the process group; ``use_mesh=False`` refuses a
group. ``run_epochs`` is the per-epoch step / eval / checkpoint cycle over
any batch source; ``train()`` feeds it the h5 corpus.
"""

from __future__ import annotations

import collections
import contextlib
import csv
import datetime
import getpass
import json
import logging
import os
import pickle
import signal
import subprocess
import threading
import time
from typing import Callable, Iterable, Iterator

import torch
import torch.distributed as dist

from ..models.registry import build_model
from ..parallel import (
    comm_device,
    data_group,
    local_device,
    rank,
    replicate,
    shard_batch_local,
    world_size,
)
from ..parallel.tp import tp_mesh
from ..utils.log import init_console_logger, init_file_logger
from ..utils.tracker import JSONLTracker, NullTracker
from . import checkpoints
from .data import AsyncBatchPipeline, data_generator, single_epoch_data_generator, to_device
from .state import TrainState, create_train_state
from .steps import make_eval_step, make_train_step

LOGGER = logging.getLogger("l3embedding_torch")
LOGGER.setLevel(logging.DEBUG)

HISTORY_CSV_FIELDS = ["epoch", "acc", "loss", "val_acc", "val_loss"]

PREEMPT_FILE = "preempt.json"


def _clear_preempt_files(model_dir: str) -> None:
    """Remove the preemption marker and its snapshot, marker FIRST: a kill
    between the two removals leaves no marker, so resume falls back to the
    epoch boundary, never to a marker pointing at a deleted snapshot."""
    for stale in (
        os.path.join(model_dir, PREEMPT_FILE),
        os.path.join(model_dir, checkpoints.PREEMPT),
    ):
        try:
            os.remove(stale)
        except OSError:
            pass


class _PreemptionGuard:
    """SIGTERM/SIGINT → a flag the loop polls at each step boundary, where
    it saves an exact-step snapshot and returns. A second signal falls back
    to the previous disposition. Handlers are installed only in the main
    thread and restored by restore()."""

    def __init__(self, enabled: bool = True):
        self.requested = False
        self._installed: list[tuple[int, object]] = []
        if not enabled or threading.current_thread() is not threading.main_thread():
            return
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                prev = signal.signal(sig, self._handler)
                self._installed.append((sig, prev))
            except (ValueError, OSError):
                pass

    def _handler(self, signum, frame):
        if self.requested:
            self.restore()
            signal.raise_signal(signum)
            return
        LOGGER.warning(
            "Received signal %d — will checkpoint and exit at the next step boundary.", signum
        )
        self.requested = True

    def restore(self):
        for sig, prev in self._installed:
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        self._installed.clear()


class _PreemptionSync:
    """The local preemption flag turned into a decision that every rank
    takes at the same poll (JAX's ``_PreemptionSync``).

    A signal reaches the ranks at different steps; a rank that stopped on
    its own flag would leave the others waiting in the next step's
    all-reduce. Each poll instead sends the local flag into a one-element
    MAX all-reduce, started asynchronously and read `lag` polls later, when
    it has long finished: every rank reads the same sequence of values and
    stops at the same poll. Without a group the local flag is read
    directly."""

    def __init__(self, local_flag: Callable[[], bool], group, lag: int):
        self.local_flag = local_flag
        self.group = group
        self.lag = max(1, lag)
        self._pending: collections.deque = collections.deque()
        if group is not None:
            self._device = comm_device(group)

    def poll(self) -> bool:
        """Call at every train and eval step; True: stop now (on every rank
        at the same call)."""
        if self.group is None:
            return self.local_flag()
        flag = torch.full((1,), 1.0 if self.local_flag() else 0.0, device=self._device)
        work = dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self.group, async_op=True)
        self._pending.append((work, flag))
        if len(self._pending) > self.lag:
            work, flag = self._pending.popleft()
            work.wait()
            return bool(flag.item() > 0)
        return False

    def close(self) -> None:
        """Wait for the reductions still in flight."""
        while self._pending:
            self._pending.popleft()[0].wait()


def get_git_commit() -> str:
    try:
        return (
            subprocess.run(
                ["git", "rev-parse", "HEAD"],
                capture_output=True,
                cwd=os.path.dirname(os.path.abspath(__file__)),
                timeout=10,
            ).stdout.decode().strip()
            or "unknown"
        )
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def get_restart_info(history_path):
    """(last_epoch, last_val_acc, last_val_loss) from the history CSV, or
    None when it has no data rows (reference train.py:208-215)."""
    last = None
    with open(history_path) as f:
        for row in csv.DictReader(f):
            last = row
    if last is None:
        return None
    return int(last["epoch"]), float(last["val_acc"]), float(last["val_loss"])


def _resolve_run_dir(output_dir, model_id, group=None):
    """A new timestamped run dir; the pid is appended on a collision. Under
    a group the chief makes it and broadcasts its name, so that every rank
    works in one directory (the clocks of two ranks can straddle a second,
    and the collision fallback can fire on one alone)."""
    model_dir = None
    if rank() == 0:
        base = os.path.join(
            output_dir, "embedding", model_id, datetime.datetime.now().strftime("%Y%m%d%H%M%S")
        )
        try:
            os.makedirs(base)
            model_dir = base
        except FileExistsError:
            model_dir = f"{base}-{os.getpid()}"
            os.makedirs(model_dir, exist_ok=True)
    if group is not None:
        name = [model_dir]
        dist.broadcast_object_list(name, src=0, group=group)
        model_dir = name[0]
    return model_dir


def _append_history_row(path, row):
    exists = os.path.exists(path)
    with open(path, "a", newline="") as f:
        w = csv.DictWriter(f, fieldnames=HISTORY_CSV_FIELDS)
        if not exists:
            w.writeheader()
        w.writerow(row)


def train(
    train_data_dir,
    validation_data_dir,
    output_dir,
    num_epochs=150,
    train_epoch_size=512,
    validation_epoch_size=1024,
    train_batch_size=64,
    validation_batch_size=64,
    model_type="cnn_L3_orig",
    random_state=20180123,
    learning_rate=1e-4,
    verbose=False,
    checkpoint_interval=10,
    log_path=None,
    disable_logging=False,
    gpus=1,
    continue_model_dir=None,
    gsheet_id=None,
    google_dev_app_name=None,
    prefetch_batches=4,
    use_mesh=True,
    profile_steps=0,
    compute_dtype="float32",
    accum_steps=1,
    db_batch_global=False,
    bn_mode="sync",
    async_checkpoints=True,
    handle_preemption=True,
    preempt_after_steps=None,
    device="cuda",
):
    """Train the AVC model of `model_type` on the h5 corpora of
    ``02_generate_samples.py``; → (model_dir, history).

    The arguments are the JAX package's ``train()``'s, plus `device`. The
    random init is the port's He-normal one from a generator seeded with
    `random_state` (not flax's numbers; resume from a ``.ckpt`` to start
    both packages from the same weights).

    async_checkpoints: encode and write checkpoints on a background thread
      (the host copy of the state is taken synchronously).
    handle_preemption: SIGTERM/SIGINT save an exact-step snapshot and
      preempt.json, then return; the next ``continue_model_dir`` run resumes
      at that batch.
    preempt_after_steps: behave as if SIGTERM arrived after N train steps
      of this run (deterministic preemption tests).
    profile_steps: a torch.profiler trace of the first N train steps into
      ``<model_dir>/profile``.
    """
    params = dict(locals())
    guard = _PreemptionGuard(enabled=handle_preemption)
    try:
        return _train_impl(guard=guard, **params)
    finally:
        guard.restore()


def _read_preempt_marker(continue_model_dir, initial_epoch, train_batch_size, train_epoch_size,
                         process_count=1, chief=True):
    """The preempt.json of a run dir, if it is valid and current: → (epoch,
    steps_done_in_epoch, checkpoint file) or None. Stale, unparsable and
    orphaned markers are removed by the chief (resume then starts at the
    epoch boundary); a marker of another process count or batch geometry
    raises: the per-rank data fast-forward would replay or skip samples."""
    preempt_path = os.path.join(continue_model_dir, PREEMPT_FILE)
    if not os.path.exists(preempt_path):
        return None
    try:
        with open(preempt_path) as f:
            info = json.load(f)
        epoch, steps_done = int(info["epoch"]), int(info["steps_done_in_epoch"])
    except (ValueError, KeyError, TypeError) as e:
        LOGGER.warning(
            "Ignoring unparsable %s (%s); resuming at the last completed epoch boundary.",
            PREEMPT_FILE, e,
        )
        if chief:
            _clear_preempt_files(continue_model_dir)
        return None
    if epoch < initial_epoch:
        # The history CSV records this epoch as complete: a kill landed
        # between the row append and the marker removal.
        LOGGER.warning(
            "Ignoring stale %s (epoch %d < next epoch %d from history); removing it.",
            PREEMPT_FILE, epoch, initial_epoch,
        )
        if chief:
            _clear_preempt_files(continue_model_dir)
        return None
    marker_ckpt = info.get("checkpoint", checkpoints.LATEST)
    if not os.path.exists(os.path.join(continue_model_dir, marker_ckpt)):
        LOGGER.warning(
            "%s references missing snapshot %s; resuming at the last completed epoch boundary instead.",
            PREEMPT_FILE, marker_ckpt,
        )
        if chief:
            _clear_preempt_files(continue_model_dir)
        return None
    saved_procs = int(info.get("process_count", 1))
    if saved_procs != process_count:
        raise ValueError(
            f"{PREEMPT_FILE} was written by a {saved_procs}-process run; resuming on "
            f"{process_count} processes would misalign the per-shard data fast-forward. "
            "Resume on the same process count (or complete the epoch there first)."
        )
    per_process = train_batch_size // process_count
    saved_bs = int(info.get("per_process_batch_size", per_process))
    if saved_bs != per_process:
        raise ValueError(
            f"{PREEMPT_FILE} was written with per-process batch size {saved_bs}; resuming "
            f"with {per_process} would misalign the data fast-forward. Resume with the "
            "same train_batch_size (or complete the epoch there first)."
        )
    saved_epoch_size = int(info.get("train_epoch_size", train_epoch_size))
    if saved_epoch_size != train_epoch_size:
        raise ValueError(
            f"{PREEMPT_FILE} was written with train_epoch_size {saved_epoch_size}; resuming "
            f"with {train_epoch_size} would misalign the data fast-forward. Resume with the "
            "same train_epoch_size (or complete the epoch there first)."
        )
    return epoch, steps_done, marker_ckpt


def _train_impl(
    guard, train_data_dir, validation_data_dir, output_dir, num_epochs, train_epoch_size,
    validation_epoch_size, train_batch_size, validation_batch_size, model_type, random_state,
    learning_rate, verbose, checkpoint_interval, log_path, disable_logging, gpus,
    continue_model_dir, gsheet_id, google_dev_app_name, prefetch_batches, use_mesh,
    profile_steps, compute_dtype, accum_steps, db_batch_global, bn_mode, async_checkpoints,
    handle_preemption, preempt_after_steps, device,
):
    if not LOGGER.handlers:
        init_console_logger(LOGGER, verbose=verbose)
        if not disable_logging:
            init_file_logger(LOGGER, log_path=log_path)
    group = data_group()
    if group is not None and not use_mesh:
        raise ValueError(
            f"use_mesh=False trains on one device, but this process is one of {world_size()}: "
            "launch one process, or keep use_mesh"
        )
    proc_count, chief = world_size(), rank() == 0
    for name, size in (("train_batch_size", train_batch_size),
                       ("validation_batch_size", validation_batch_size)):
        if size % proc_count:
            raise ValueError(f"{name} {size} not divisible by process_count {proc_count}")
    device = local_device(device) if group is not None else torch.device(device)

    # Model id from the data dir's name (reference train.py:231-234).
    data_subset_name = os.path.basename(os.path.normpath(train_data_dir))
    if "_" in data_subset_name:
        data_subset_name = data_subset_name[: data_subset_name.rindex("_")]
    model_id = os.path.join(data_subset_name, model_type)

    param_dict = {
        "username": getpass.getuser(),
        "train_data_dir": train_data_dir,
        "validation_data_dir": validation_data_dir,
        "model_id": model_id,
        "output_dir": output_dir,
        "num_epochs": num_epochs,
        "train_epoch_size": train_epoch_size,
        "validation_epoch_size": validation_epoch_size,
        "train_batch_size": train_batch_size,
        "validation_batch_size": validation_batch_size,
        "model_type": model_type,
        "random_state": random_state,
        "learning_rate": learning_rate,
        "verbose": verbose,
        "checkpoint_interval": checkpoint_interval,
        "log_path": log_path,
        "disable_logging": disable_logging,
        "gpus": gpus,
        "use_mesh": use_mesh,
        "continue_model_dir": continue_model_dir,
        "git_commit": get_git_commit(),
        "gsheet_id": gsheet_id,
        "google_dev_app_name": google_dev_app_name,
        "backend": f"torch-{device.type}",
        "num_devices": proc_count,
        "compute_dtype": compute_dtype,
    }
    LOGGER.info("Training with the following arguments: %s", param_dict)

    spec = build_model(model_type)
    if continue_model_dir:
        model_dir = continue_model_dir
        os.makedirs(model_dir, exist_ok=True)
    else:
        model_dir = _resolve_run_dir(output_dir, model_id, group)
    param_dict["model_dir"] = model_dir

    if chief:
        with open(os.path.join(model_dir, "config.json"), "w") as fd:
            json.dump(param_dict, fd, indent=2)
        # Everything needed to rebuild the model (replaces the reference's
        # pickled Keras spec, train.py:306-314).
        with open(os.path.join(model_dir, "model.json"), "w") as fd:
            json.dump(
                {
                    "framework": "l3embedding_torch",
                    "model_type": model_type,
                    "audio_input_shape": list(spec.audio_input_shape),
                    "video_input_shape": list(spec.video_input_shape),
                    "audio_embedding_pooling": {
                        k: list(v) for k, v in spec.audio_embedding_pooling.items()
                    },
                },
                fd,
                indent=2,
            )

    state = create_train_state(
        spec,
        torch.Generator().manual_seed(random_state),
        learning_rate,
        torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32,
        device,
        db_batch_global,
    )

    initial_epoch = 0
    resume_step_in_epoch = 0
    best_val_acc = float("-inf")
    best_val_loss = float("inf")
    if continue_model_dir is not None:
        hist_path = os.path.join(continue_model_dir, "history_csvlog.csv")
        if os.path.exists(hist_path):
            restart = get_restart_info(hist_path)
            if restart is None:
                LOGGER.warning("history CSV %s has no data rows; resuming from epoch 0", hist_path)
            else:
                last_epoch_idx, best_val_acc, best_val_loss = restart
                initial_epoch = last_epoch_idx + 1
        resume_ckpt = checkpoints.LATEST
        marker = _read_preempt_marker(
            continue_model_dir, initial_epoch, train_batch_size, train_epoch_size,
            proc_count, chief,
        )
        if marker is not None:
            initial_epoch, resume_step_in_epoch, resume_ckpt = marker
            LOGGER.info(
                "Found %s: resuming mid-epoch %d at step %d from %s",
                PREEMPT_FILE, initial_epoch, resume_step_in_epoch, resume_ckpt,
            )
        checkpoints.load_state(os.path.join(continue_model_dir, resume_ckpt), state)
        LOGGER.info("Resuming from epoch %d", initial_epoch)
    replicate(state, group)

    train_step = make_train_step(accum_steps=accum_steps, bn_mode=bn_mode, group=group)
    eval_step = make_eval_step(group)

    if gsheet_id and chief:
        tracker = JSONLTracker(os.path.join(model_dir, "experiments.jsonl"))
        tracker.upsert(dict(param_dict))
    else:
        tracker = NullTracker()

    if continue_model_dir is not None:
        train_start_batch_idx = train_epoch_size * initial_epoch + resume_step_in_epoch
    else:
        train_start_batch_idx = None
    # Each rank streams its own file shard of the corpus, global // world
    # rows a step (one process: the whole corpus, as the reference).
    shard = dict(shard_index=rank(), shard_count=proc_count)
    train_gen = (
        shard_batch_local(b, train_batch_size, group)
        for b in data_generator(
            train_data_dir,
            batch_size=train_batch_size // proc_count,
            random_state=random_state,
            start_batch_idx=train_start_batch_idx,
            **shard,
        )
    )

    def validation_batches():
        # A fresh, identically seeded stream every epoch (reference
        # train.py:198-205, 391-395).
        return single_epoch_data_generator(
            validation_data_dir,
            validation_epoch_size,
            batch_size=validation_batch_size // proc_count,
            random_state=random_state,
            **shard,
        )

    history, _ = run_epochs(
        state, train_step, eval_step, model_dir, train_gen, validation_batches,
        num_epochs=num_epochs,
        train_epoch_size=train_epoch_size,
        validation_epoch_size=validation_epoch_size,
        train_batch_size=train_batch_size,
        initial_epoch=initial_epoch,
        resume_step_in_epoch=resume_step_in_epoch,
        best_val_acc=best_val_acc,
        best_val_loss=best_val_loss,
        checkpoint_interval=checkpoint_interval,
        async_checkpoints=async_checkpoints,
        prefetch_batches=prefetch_batches,
        profile_steps=profile_steps,
        should_stop=lambda: guard.requested,
        preempt_after_steps=preempt_after_steps,
        tracker=tracker,
        group=group,
        chief=chief,
    )
    return model_dir, history


def _start_profiler(model_dir: str, device: torch.device):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def run_epochs(
    state: TrainState,
    train_step: Callable,
    eval_step: Callable,
    model_dir: str,
    train_batches: Iterator[dict],
    validation_batches: Callable[[], Iterable[dict]],
    *,
    num_epochs: int,
    train_epoch_size: int,
    validation_epoch_size: int,
    train_batch_size: int,
    initial_epoch: int = 0,
    resume_step_in_epoch: int = 0,
    best_val_acc: float = float("-inf"),
    best_val_loss: float = float("inf"),
    checkpoint_interval: int = 10,
    async_checkpoints: bool = True,
    prefetch_batches: int = 4,
    profile_steps: int = 0,
    should_stop: Callable[[], bool] = lambda: False,
    preempt_after_steps: int | None = None,
    tracker=None,
    group=None,
    chief: bool = True,
):
    """The per-epoch cycle of ``train()`` over any source of host batches
    (numpy dicts in storage dtypes): `train_batches`, one stream over every
    epoch, and `validation_batches()`, a fresh iterator each epoch. Each
    epoch: train_epoch_size steps, validation_epoch_size eval steps, the
    four checkpoint roles, the history row and pickles. → (history,
    preempted); a finished run's history also holds the seconds of each
    epoch, of each step's launch, of each wait for a batch and of each
    epoch's checkpoint writes. Batches are uploaded to the model's device
    on the prefetch thread.

    should_stop is this process's preemption flag (and preempt_after_steps
    raises it after that many train steps of this call). Under `group` the
    ranks poll it through ``_PreemptionSync`` and stop together, a few
    steps after the first rank raised it; only the `chief` writes
    checkpoints, markers, history files and traces.
    """
    if tp_mesh(state.model) is not None:
        raise NotImplementedError("run_epochs writes checkpoints on the chief alone; a tensor-parallel "
                                  "state is gathered by every rank (checkpoints.save_state)")
    tracker = tracker or NullTracker()
    device = next(state.model.parameters()).device
    history = {"acc": [], "loss": [], "val_acc": [], "val_loss": []}
    epoch_times, batch_times, data_wait_times, checkpoint_times = [], [], [], []
    history_csv = os.path.join(model_dir, "history_csvlog.csv")
    history_checkpoint = os.path.join(model_dir, "history_checkpoint.pkl")
    best_train_acc, best_train_loss = float("-inf"), float("inf")

    def staged(gen):
        # The upload of batch k+1..k+prefetch overlaps the step on batch k.
        for b in gen:
            yield to_device(b, device)

    profile_remaining = int(profile_steps) if chief else 0
    prof = _start_profiler(model_dir, device) if profile_remaining > 0 else None
    saver = checkpoints.AsyncCheckpointWriter() if async_checkpoints and chief else None

    def save_ckpt(filename):
        if not chief:
            return
        path = os.path.join(model_dir, filename)
        if saver is not None:
            saver.save(path, state)
        else:
            checkpoints.save_state(path, state)

    def save_preempt_snapshot(epoch, steps_done_in_epoch):
        """Synchronous exact-step snapshot into its own file, then the
        marker, written atomically; LATEST is never overwritten here, so a
        kill at any point leaves either no marker (epoch-boundary resume)
        or a complete marker with its snapshot."""
        if saver is not None:
            saver.close()  # drain pending writes first so LATEST is last
        if chief:
            # Retract an older marker before overwriting the snapshot it names.
            try:
                os.remove(os.path.join(model_dir, PREEMPT_FILE))
            except OSError:
                pass
            checkpoints.save_state(os.path.join(model_dir, checkpoints.PREEMPT), state)
            marker = {
                "epoch": epoch,
                "steps_done_in_epoch": steps_done_in_epoch,
                "global_batch_idx": epoch * train_epoch_size + steps_done_in_epoch,
                "process_count": proc_count,
                "per_process_batch_size": train_batch_size // proc_count,
                "train_epoch_size": train_epoch_size,
                "checkpoint": checkpoints.PREEMPT,
            }
            checkpoints._write_atomic(
                os.path.join(model_dir, PREEMPT_FILE), json.dumps(marker).encode()
            )
        LOGGER.warning(
            "Preempted: saved %s at epoch %d step %d; rerun with --continue-model-dir %s "
            "to resume at this exact batch.",
            checkpoints.PREEMPT, epoch, steps_done_in_epoch, model_dir,
        )

    steps_run_total = 0
    preempted = False
    proc_count = 1 if group is None else dist.get_world_size(group)
    psync = _PreemptionSync(
        lambda: should_stop() or (
            preempt_after_steps is not None and steps_run_total >= preempt_after_steps),
        group, lag=max(2, 2 * prefetch_batches),
    )

    @contextlib.contextmanager
    def _training_cleanup():
        try:
            yield
        finally:
            psync.close()
            if saver is not None:
                saver.close()
            if prof is not None and profile_remaining > 0:
                prof.stop()

    with _training_cleanup(), AsyncBatchPipeline(
        staged(train_batches), prefetch=prefetch_batches
    ) as train_pipe:
        for epoch in range(initial_epoch, num_epochs):
            epoch_start = time.time()
            epoch_step_offset = resume_step_in_epoch if epoch == initial_epoch else 0
            steps_this_epoch = train_epoch_size - epoch_step_offset
            # Metrics accumulate on the device; the host reads them once per
            # epoch. A short window of per-step losses, read oldest first,
            # keeps the host from queueing the whole epoch ahead.
            tr_loss_sum = tr_acc_sum = None
            inflight = collections.deque()
            max_inflight = max(2, 2 * prefetch_batches)
            for step_in_epoch in range(steps_this_epoch):
                t0 = time.perf_counter()
                batch = next(train_pipe)
                data_wait_times.append(time.perf_counter() - t0)
                state, metrics = train_step(state, batch)
                step_loss = metrics["loss"] + metrics["reg_loss"]
                if tr_loss_sum is None:
                    tr_loss_sum, tr_acc_sum = step_loss, metrics["acc"]
                else:
                    tr_loss_sum = tr_loss_sum + step_loss
                    tr_acc_sum = tr_acc_sum + metrics["acc"]
                inflight.append(metrics["loss"])
                if len(inflight) > max_inflight:
                    float(inflight.popleft())
                # Launch interval, not device time: steps run asynchronously.
                batch_times.append(time.perf_counter() - t0)
                if profile_remaining > 0:
                    profile_remaining -= 1
                    if profile_remaining == 0:
                        float(metrics["loss"])  # the profiled steps ran inside the trace
                        prof.stop()
                        trace_dir = os.path.join(model_dir, "profile")
                        os.makedirs(trace_dir, exist_ok=True)
                        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
                        LOGGER.info("Profiler trace written to %s", trace_dir)
                steps_run_total += 1
                if psync.poll():
                    float(metrics["loss"])
                    inflight.clear()
                    save_preempt_snapshot(epoch, epoch_step_offset + step_in_epoch + 1)
                    preempted = True
                    break
            if preempted:
                break
            inflight.clear()
            # After a resume that landed on the epoch's last step, this epoch
            # ran no train step here: its train metrics are unrecoverable.
            if steps_this_epoch > 0:
                tr_loss_mean = float(tr_loss_sum) / steps_this_epoch
                tr_acc_mean = float(tr_acc_sum) / steps_this_epoch
            else:
                tr_loss_mean = tr_acc_mean = float("nan")

            # Validation; steps_done == train_epoch_size in a snapshot taken
            # here means "train phase complete, validation pending".
            va_loss_sum = va_acc_sum = None
            with AsyncBatchPipeline(
                staged(validation_batches()), prefetch=prefetch_batches
            ) as val_pipe:
                for _ in range(validation_epoch_size):
                    metrics = eval_step(state, next(val_pipe))
                    if va_loss_sum is None:
                        va_loss_sum, va_acc_sum = metrics["loss"], metrics["acc"]
                    else:
                        va_loss_sum = va_loss_sum + metrics["loss"]
                        va_acc_sum = va_acc_sum + metrics["acc"]
                    if psync.poll():
                        float(metrics["loss"])
                        save_preempt_snapshot(epoch, train_epoch_size)
                        preempted = True
                        break
            if preempted:
                break
            va_loss_mean = float(va_loss_sum) / validation_epoch_size
            va_acc_mean = float(va_acc_sum) / validation_epoch_size

            epoch_time = time.time() - epoch_start
            epoch_times.append(epoch_time)
            row = {
                "epoch": epoch,
                "acc": tr_acc_mean,
                "loss": tr_loss_mean,
                "val_acc": va_acc_mean,
                "val_loss": va_loss_mean,
            }
            LOGGER.info(
                "Epoch %d: loss=%.4f acc=%.4f val_loss=%.4f val_acc=%.4f (%.1fs, %.1f pairs/s)",
                epoch, row["loss"], row["acc"], row["val_loss"], row["val_acc"], epoch_time,
                train_epoch_size * train_batch_size / max(epoch_time, 1e-9),
            )

            # Checkpoint roles (reference train.py:326-355).
            t0 = time.perf_counter()
            save_ckpt(checkpoints.LATEST)
            if row["val_acc"] > best_val_acc:
                best_val_acc = row["val_acc"]
                save_ckpt(checkpoints.BEST_VALID_ACC)
            if row["val_loss"] < best_val_loss:
                best_val_loss = row["val_loss"]
                save_ckpt(checkpoints.BEST_VALID_LOSS)
            if (epoch + 1) % checkpoint_interval == 0:
                save_ckpt(checkpoints.PERIODIC_FMT.format(epoch=epoch))
            if saver is not None:
                # The history row below tells resume that LATEST holds this
                # epoch's end: it must not reach the disk before that file.
                saver.flush()
            checkpoint_times.append(time.perf_counter() - t0)

            for k in ("acc", "loss", "val_acc", "val_loss"):
                history[k].append(row[k])
            if chief:
                _append_history_row(history_csv, row)
                with open(history_checkpoint, "wb") as fp:
                    pickle.dump({"loss": history["loss"], "val_loss": history["val_loss"]}, fp)

            # A completed epoch supersedes a mid-epoch snapshot marker.
            if chief and epoch == initial_epoch and resume_step_in_epoch:
                _clear_preempt_files(model_dir)

            best_train_acc = max(best_train_acc, row["acc"])
            best_train_loss = min(best_train_loss, row["loss"])
            tracker.update(
                model_dir,
                {
                    "latest_epoch": epoch,
                    "latest_train_loss": row["loss"],
                    "latest_validation_loss": row["val_loss"],
                    "latest_train_acc": row["acc"],
                    "latest_validation_acc": row["val_acc"],
                    "best_train_loss": best_train_loss,
                    "best_validation_loss": best_val_loss,
                    "best_train_acc": best_train_acc,
                    "best_validation_acc": best_val_acc,
                },
            )

    if preempted:
        LOGGER.info("Exiting cleanly after preemption snapshot.")
    else:
        LOGGER.info("Done training. Saving results to disk...")
        history["epoch_times"] = epoch_times
        history["batch_times"] = batch_times
        # What the loop waited for: the next batch from the prefetch thread,
        # and each epoch's checkpoint snapshots and writes (to the end of
        # the flush).
        history["data_wait_times"] = data_wait_times
        history["checkpoint_times"] = checkpoint_times
        if chief:
            with open(os.path.join(model_dir, "history.pkl"), "wb") as fd:
                pickle.dump(history, fd)
        LOGGER.info("Done!")
    if group is not None:
        dist.barrier(group)  # the ranks leave once the chief's files are written
    return history, preempted
