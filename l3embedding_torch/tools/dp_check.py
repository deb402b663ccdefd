"""One rank of a data-parallel or tensor-parallel check, or of a timing
run, on the card(s).

    python -m torch.distributed.run --standalone --nproc-per-node N \\
        -m l3embedding_torch.tools.dp_check check WORK_DIR
    python -m torch.distributed.run --standalone --nproc-per-node N \\
        -m l3embedding_torch.tools.dp_check tp WORK_DIR --model-axis 2
    python -m torch.distributed.run --standalone --nproc-per-node N \\
        -m l3embedding_torch.tools.dp_check time WORK_DIR --batch-per-rank 64 [--model-axis 2]

Each rank trains on ``cuda:LOCAL_RANK`` (ranks that outnumber the cards
share them, over gloo; one rank per card runs over NCCL), from the seeded
cnn_L3_melspec2 state of ``--seed``, on its rows of the global batches in
``WORK_DIR/batches.npz`` (``video``, ``audio``, ``label``, each with a
leading batch-index axis).

``check``: through the user entry points — ``make_train_step(group=...)``
in f32 and bf16 and with ``bn_mode="per_replica"``, ``make_eval_step``,
``run_epochs`` over the rank's in-memory batches (one epoch of 4 steps and
2 evaluations, checkpoints every epoch), and a run that rank 1 alone is
told to stop after 2 steps — with every kernel count at 0 before and read
after. Rank 0 writes ``rank0_steps.npz`` (gradients, running statistics,
metrics of each step); every rank writes ``rank{r}.json`` (launch counts,
a checksum of its parameters after each step, its history, the files it
opened for writing, where the preempted run stopped, the ms of a step).

``tp``: the state replicated, then split by ``tp_shard_state`` over the
model axis of ``create_mesh(--model-axis)``; an f32, a bf16 and an
``accum_steps=2`` f32 step and an eval step on this data index's rows of
batch 0, the f32 step's state through ``save_state`` (which every rank
calls) to ``tp_f32.ckpt``, every kernel count at 0 before and read after.
Rank 0 writes ``tp_steps.npz`` (the gathered gradients and running
statistics, metrics of each step); every rank writes ``tp_rank{r}.json``
(its mesh coordinates, the SHA-256 of its split slices and of its
replicated leaves after each step, its parameter and Adam bytes, its launch
counts).

``time``: median ms of an f32 and a bf16 sync step at --batch-per-rank rows
a data replica (2 warm-up steps, then --reps), the state split over
--model-axis ranks, written by rank 0 to ``time_{N}_m{M}.json``.
"""

from __future__ import annotations

import argparse
import builtins
import hashlib
import itertools
import json
import os
import statistics
import time

import numpy as np
import torch
import torch.distributed as dist

from ..models.registry import build_model
from ..ops import mel_kernel, spec_kernel
from ..parallel import (
    create_mesh,
    data_group,
    initialize_distributed,
    local_device,
    rank,
    replicate,
    shard_batch,
    world_size,
)
from ..parallel.tp import gather_tensors, split_leaves, tp_shard_state
from ..training import checkpoints, loop
from ..training.state import create_train_state
from ..training.steps import make_eval_step, make_train_step

MODEL = "cnn_L3_melspec2"
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _batch(z, i: int, device, group) -> dict:
    """This rank's rows of global batch i (its data index's under a mesh),
    on `device`."""
    rows = shard_batch({k: z[k][i] for k in ("video", "audio", "label")}, group)
    return {k: torch.from_numpy(np.ascontiguousarray(x)).to(device) for k, x in rows.items()}


def _state(dtype, device, seed, mesh=None):
    """The seeded state, replicated over the job, split over `mesh`'s model
    axis when it has one."""
    state = create_train_state(build_model(MODEL), torch.Generator().manual_seed(seed), 1e-4,
                               dtype, device)
    replicate(state, data_group())
    return state if mesh is None else tp_shard_state(state, mesh)


def _launches() -> dict:
    return {**{f"mel_frontend_{k}": v for k, v in mel_kernel.LAUNCHES.items()},
            **{f"spec_frontend_{k}": v for k, v in spec_kernel.LAUNCHES.items()}}


def digests(model) -> dict:
    """SHA-256 of each split slice of this rank and of its replicated leaves."""
    split = split_leaves(MODEL)
    out, replicated = {}, hashlib.sha256()
    for name, t in [*model.named_parameters(), *model.named_buffers()]:
        data = t.detach().cpu().contiguous().numpy().tobytes()
        if name in split:
            out[name] = hashlib.sha256(data).hexdigest()
        else:
            replicated.update(data)
    out["replicated"] = replicated.hexdigest()
    return out


def _checksum(model) -> float:
    with torch.no_grad():
        return float(sum(p.double().sum() * (i + 1) for i, p in enumerate(model.parameters())))


class WriteLog:
    """The paths this process opens for writing while the block runs."""

    def __enter__(self):
        self.paths, self._open = [], builtins.open

        def opener(file, mode="r", *args, **kwargs):
            if any(c in mode for c in "wax+"):
                self.paths.append(os.fspath(file))
            return self._open(file, mode, *args, **kwargs)

        builtins.open = opener
        return self

    def __exit__(self, *exc):
        builtins.open = self._open
        return False


def _step_ms(state, step, batch, reps=10) -> list[float]:
    times = []
    for i in range(reps + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
    return times


def check(work: str, seed: int) -> None:
    device, group = local_device(), data_group()
    z = np.load(os.path.join(work, "batches.npz"))
    if group is None:
        raise SystemExit("dp_check check: needs a job of two or more processes")
    record, arrays = {"rank": rank(), "world": world_size(), "device": str(device),
                      "backend": dist.get_backend(group)}, {}
    mel_kernel.LAUNCHES.clear()
    spec_kernel.LAUNCHES.clear()
    batch = _batch(z, 0, device, group)
    for name, dtype, bn_mode in (("f32", torch.float32, "sync"), ("bf16", torch.bfloat16, "sync"),
                                 ("per_replica", torch.float32, "per_replica")):
        state = _state(dtype, device, seed)
        state, metrics = make_train_step(bn_mode=bn_mode, group=group)(state, batch)
        record[f"{name}_checksum"] = _checksum(state.model)
        record[f"{name}_metrics"] = {k: float(v) for k, v in metrics.items()}
        if rank() == 0:
            for n, p in state.model.named_parameters():
                arrays[f"{name}/grad/{n}"] = p.grad.float().cpu().numpy()
            for n, b in state.model.named_buffers():
                if "running_" in n:
                    arrays[f"{name}/stat/{n}"] = b.double().cpu().numpy()
    record["eval"] = {k: float(v) for k, v in make_eval_step(group)(state, batch).items()}

    # The epoch cycle on this rank's in-memory batches (the h5 reader is
    # the one-process path's), into one run dir that the chief makes.
    out = os.path.join(work, "runs")
    model_dir = loop._resolve_run_dir(out, f"dp/{MODEL}", group)
    train_b = [_batch(z, i, "cpu", group) for i in range(1, 5)]
    valid_b = [_batch(z, i, "cpu", group) for i in range(5, 7)]
    state = _state(torch.float32, device, seed)
    with WriteLog() as writes:
        history, preempted = loop.run_epochs(
            state, make_train_step(group=group), make_eval_step(group), model_dir,
            itertools.cycle(train_b), lambda: iter(valid_b), num_epochs=1, train_epoch_size=4,
            validation_epoch_size=2, train_batch_size=z["label"].shape[1], checkpoint_interval=1,
            prefetch_batches=1, group=group, chief=rank() == 0)
    record.update(model_dir=model_dir, writes=writes.paths, preempted=preempted,
                  history={k: history[k] for k in ("loss", "acc", "val_loss", "val_acc")},
                  run_checksum=_checksum(state.model))

    # Rank 1 alone is told to stop after 2 steps: every rank must stop at
    # the same step.
    state = _state(torch.float32, device, seed)
    steps_here = [0]
    step = make_train_step(group=group)

    def counted(state, batch):
        steps_here[0] += 1
        return step(state, batch)

    model_dir = loop._resolve_run_dir(os.path.join(work, "preempt"), f"dp/{MODEL}", group)
    _, preempted = loop.run_epochs(
        state, counted, make_eval_step(group), model_dir, itertools.cycle(train_b),
        lambda: iter(valid_b), num_epochs=2, train_epoch_size=4, validation_epoch_size=2,
        train_batch_size=z["label"].shape[1], prefetch_batches=1, group=group, chief=rank() == 0,
        should_stop=lambda: rank() == 1 and steps_here[0] >= 2)
    record.update(preempt_stopped=preempted, preempt_step=state.step)
    torch.cuda.synchronize()
    record["launches"] = _launches()

    state = _state(torch.float32, device, seed)
    record["step_ms"] = _step_ms(state, make_train_step(group=group), batch)
    with open(os.path.join(work, f"rank{rank()}.json"), "w") as f:
        json.dump(record, f)
    if rank() == 0:
        np.savez(os.path.join(work, "rank0_steps.npz"), **arrays)


def check_tp(work: str, seed: int, model_axis: int) -> None:
    device, mesh = local_device(), create_mesh(model_axis)
    if mesh.model == 1:
        raise SystemExit("dp_check tp: needs --model-axis of two or more")
    z = np.load(os.path.join(work, "batches.npz"))
    record = {"rank": rank(), "world": world_size(), "device": str(device), "backend": dist.get_backend(),
              "mesh": [mesh.data, mesh.model, mesh.data_index, mesh.model_index]}
    arrays = {}
    mel_kernel.LAUNCHES.clear()
    spec_kernel.LAUNCHES.clear()
    batch = _batch(z, 0, device, mesh)
    for name, dtype, accum_steps in (("f32", torch.float32, 1), ("bf16", torch.bfloat16, 1),
                                     ("accum2", torch.float32, 2)):
        state = _state(dtype, device, seed, mesh)
        state, metrics = make_train_step(accum_steps=accum_steps, group=mesh)(state, batch)
        record[f"{name}_metrics"] = {k: float(v) for k, v in metrics.items()}
        record[f"{name}_digests"] = digests(state.model)
        grads = gather_tensors({n: p.grad for n, p in state.model.named_parameters()}, MODEL, mesh)
        stats = gather_tensors({n: b for n, b in state.model.named_buffers() if "running_" in n}, MODEL, mesh)
        if rank() == 0:
            arrays.update({f"{name}/grad/{n}": g.float().numpy() for n, g in grads.items()})
            arrays.update({f"{name}/stat/{n}": b.double().numpy() for n, b in stats.items()})
        if name == "f32":
            checkpoints.save_state(os.path.join(work, "tp_f32.ckpt"), state)
            record["eval"] = {k: float(v) for k, v in make_eval_step(mesh)(state, batch).items()}
            record["param_bytes"] = sum(p.numel() * p.element_size() for p in state.model.parameters())
            record["adam_bytes"] = sum(t.numel() * t.element_size() for s in state.optimizer.state.values()
                                       for t in s.values() if torch.is_tensor(t))
    torch.cuda.synchronize()
    record["launches"] = _launches()
    with open(os.path.join(work, f"tp_rank{rank()}.json"), "w") as f:
        json.dump(record, f)
    if rank() == 0:
        np.savez(os.path.join(work, "tp_steps.npz"), **arrays)


def time_steps(work: str, seed: int, batch_per_rank: int, model_axis: int, reps: int) -> None:
    device, mesh = local_device(), create_mesh(model_axis)
    rng = np.random.RandomState(seed + mesh.data_index)
    labels = rng.randint(0, 2, batch_per_rank)
    batch = {
        "video": torch.from_numpy(rng.randint(0, 256, (batch_per_rank, 224, 224, 3), dtype=np.uint8)).to(device),
        "audio": torch.from_numpy((rng.randn(batch_per_rank, 1, 48000) * 3000).astype(np.int16)).to(device),
        "label": torch.from_numpy(np.stack([labels, 1 - labels], 1).astype(np.float32)).to(device),
    }
    result = {"world": world_size(), "backend": dist.get_backend() if world_size() > 1 else None,
              "batch_per_rank": batch_per_rank, "model_axis": model_axis}
    for name, dtype in DTYPES.items():
        state = _state(dtype, device, seed, mesh)
        times = _step_ms(state, make_train_step(group=mesh), batch, reps)
        result[name] = {"median_ms": statistics.median(times), "min_ms": min(times), "max_ms": max(times),
                        "param_bytes": sum(p.numel() * p.element_size() for p in state.model.parameters())}
        del state
        torch.cuda.empty_cache()
    if rank() == 0:
        with open(os.path.join(work, f"time_{world_size()}_m{model_axis}.json"), "w") as f:
            json.dump(result, f)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("mode", choices=["check", "tp", "time"])
    parser.add_argument("work_dir")
    parser.add_argument("--seed", type=int, default=5)
    parser.add_argument("--batch-per-rank", type=int, default=64, help="rows a data replica (time)")
    parser.add_argument("--model-axis", type=int, default=1)
    parser.add_argument("--reps", type=int, default=10, help="timed steps (time)")
    args = parser.parse_args(argv)
    initialize_distributed()
    try:
        if args.mode == "check":
            check(args.work_dir, args.seed)
        elif args.mode == "tp":
            check_tp(args.work_dir, args.seed, args.model_axis)
        else:
            time_steps(args.work_dir, args.seed, args.batch_per_rank, args.model_axis, args.reps)
    finally:
        if dist.is_initialized():
            dist.barrier()
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
