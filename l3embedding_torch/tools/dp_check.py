"""One rank of a data-parallel check or timing run on the card(s).

    python -m torch.distributed.run --standalone --nproc-per-node N \\
        -m l3embedding_torch.tools.dp_check check WORK_DIR
    python -m torch.distributed.run --standalone --nproc-per-node N \\
        -m l3embedding_torch.tools.dp_check time WORK_DIR --batch-per-rank 64

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

``time``: median ms of an f32 and a bf16 sync step at --batch-per-rank rows
a rank (2 warm-up steps, then 10), written by rank 0 to ``time_{N}.json``.
"""

from __future__ import annotations

import argparse
import builtins
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
from ..parallel import data_group, initialize_distributed, local_device, rank, replicate, world_size
from ..training import loop
from ..training.state import create_train_state
from ..training.steps import make_eval_step, make_train_step

MODEL = "cnn_L3_melspec2"
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _batch(z, i: int, device) -> dict:
    """This rank's rows of global batch i, on `device`."""
    n = world_size()
    out = {}
    for k in ("video", "audio", "label"):
        x = z[k][i]
        b = x.shape[0] // n
        out[k] = torch.from_numpy(np.ascontiguousarray(x[rank() * b:(rank() + 1) * b])).to(device)
    return out


def _state(dtype, device, seed):
    state = create_train_state(build_model(MODEL), torch.Generator().manual_seed(seed), 1e-4,
                               dtype, device)
    return replicate(state, data_group())


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
    batch = _batch(z, 0, device)
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
    train_b = [_batch(z, i, "cpu") for i in range(1, 5)]
    valid_b = [_batch(z, i, "cpu") for i in range(5, 7)]
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
    record["launches"] = {**{f"mel_frontend_{k}": v for k, v in mel_kernel.LAUNCHES.items()},
                          **{f"spec_frontend_{k}": v for k, v in spec_kernel.LAUNCHES.items()}}

    state = _state(torch.float32, device, seed)
    record["step_ms"] = _step_ms(state, make_train_step(group=group), batch)
    with open(os.path.join(work, f"rank{rank()}.json"), "w") as f:
        json.dump(record, f)
    if rank() == 0:
        np.savez(os.path.join(work, "rank0_steps.npz"), **arrays)


def time_steps(work: str, seed: int, batch_per_rank: int) -> None:
    device, group = local_device(), data_group()
    rng = np.random.RandomState(seed + rank())
    labels = rng.randint(0, 2, batch_per_rank)
    batch = {
        "video": torch.from_numpy(rng.randint(0, 256, (batch_per_rank, 224, 224, 3), dtype=np.uint8)).to(device),
        "audio": torch.from_numpy((rng.randn(batch_per_rank, 1, 48000) * 3000).astype(np.int16)).to(device),
        "label": torch.from_numpy(np.stack([labels, 1 - labels], 1).astype(np.float32)).to(device),
    }
    result = {"world": world_size(), "backend": dist.get_backend(group) if group else None,
              "batch_per_rank": batch_per_rank}
    for name, dtype in DTYPES.items():
        state = _state(dtype, device, seed)
        times = _step_ms(state, make_train_step(group=group), batch)
        result[name] = {"median_ms": statistics.median(times), "min_ms": min(times), "max_ms": max(times)}
        del state
        torch.cuda.empty_cache()
    if rank() == 0:
        with open(os.path.join(work, f"time_{world_size()}.json"), "w") as f:
            json.dump(result, f)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("mode", choices=["check", "time"])
    parser.add_argument("work_dir")
    parser.add_argument("--seed", type=int, default=5)
    parser.add_argument("--batch-per-rank", type=int, default=64)
    args = parser.parse_args(argv)
    initialize_distributed()
    try:
        if args.mode == "check":
            check(args.work_dir, args.seed)
        else:
            time_steps(args.work_dir, args.seed, args.batch_per_rank)
    finally:
        if dist.is_initialized():
            dist.barrier()
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
