"""One rank of the 2-process data-parallel job of
``tests/test_torch_port_parallel.py`` (gloo on the CPU, tiny_L3).

    RANK=r WORLD_SIZE=2 MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/torch_port_parallel_worker.py WORK_DIR

WORK_DIR holds what the test wrote: ``state0.ckpt`` (the seeded step-0
state), the global batches (``batch.npz`` of 4 rows, ``batch8.npz`` of 8,
``batch8_quiet.npz`` of 8 whose last 4 rows are quiet) and ``train_h5`` /
``valid_h5``. Each rank writes its results there: one step of each scenario
(``SCENARIOS``: sync and per_replica at 4 rows, sync at 8, accumulation over
2 microbatches, a db_batch_global model, the eval step, and four planted
faults) as a ``.ckpt`` of the new state and an ``.npz`` of gradients and
metrics, then the ``train()`` runs (uninterrupted; preempted on rank 1
alone; resumed) with a JSON record of what each rank saw and wrote. Imports
no JAX.
"""

import contextlib
import json
import os
import shutil
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from l3embedding_torch.compat.from_jax import avc_leaves  # noqa: E402
from l3embedding_torch.models import towers  # noqa: E402
from l3embedding_torch.models.registry import build_model  # noqa: E402
from l3embedding_torch.parallel import (  # noqa: E402
    data_group,
    initialize_distributed,
    rank,
    replicate,
    shard_batch,
)
from l3embedding_torch.tools.dp_check import WriteLog  # noqa: E402
from l3embedding_torch.training import checkpoints, loop, steps  # noqa: E402
from l3embedding_torch.training.state import create_train_state  # noqa: E402

MODEL = "tiny_L3"
LR = 1e-4
TRAIN_ARGS = dict(
    num_epochs=2, train_epoch_size=4, validation_epoch_size=1, train_batch_size=8,
    validation_batch_size=8, model_type=MODEL, random_state=11, learning_rate=LR,
    checkpoint_interval=10, disable_logging=True, prefetch_batches=1, device="cpu",
)


# ---------------------------------------------------------------- planted faults

def _detached_sum(t, group):
    """The trap: an in-place all-reduce autograd does not see, so the
    gradient flows as if the statistics were this rank's alone."""
    dist.all_reduce(t, group=group)
    return t


def _averaged_variances(x, group):
    """Each rank's mean and biased variance, averaged over the ranks."""
    dims = (0, 2, 3)
    mean = x.mean(dims)
    var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
    both = towers._all_reduce_sum(torch.cat([mean, var]), group) / dist.get_world_size(group)
    c = x.shape[1]
    return both[:c], both[c:]


def _broadcast_buffers(model, group):
    """DDP's broadcast_buffers: rank 0's running statistics on every rank."""
    with torch.no_grad():
        for b in steps._running_stats(model):
            dist.broadcast(b, src=0, group=group)


FAULTS = {
    "fault_detached": (towers, "_all_reduce_sum", _detached_sum),
    "fault_var_avg": (towers, "_batch_moments", _averaged_variances),
    "fault_broadcast_buffers": (steps, "_average_running_stats", _broadcast_buffers),
    # Each rank's own rows' dB reference (the refusal's reason before).
    "fault_db_local": (steps, "batch_global_db", lambda group: contextlib.nullcontext()),
}

# name → (bn_mode, global batch, accum_steps, db_batch_global)
SCENARIOS = {
    "sync": ("sync", "batch", 1, False),
    "per_replica": ("per_replica", "batch", 1, False),
    "sync8": ("sync", "batch8", 1, False),
    "accum2": ("sync", "batch8", 2, False),
    "db_global": ("sync", "batch8_quiet", 1, True),
    "fault_detached": ("sync", "batch", 1, False),
    "fault_var_avg": ("sync", "batch", 1, False),
    "fault_broadcast_buffers": ("per_replica", "batch", 1, False),
    "fault_db_local": ("sync", "batch8_quiet", 1, True),
}


# ---------------------------------------------------------------- steps

def fresh_state(work, db_batch_global=False):
    state = create_train_state(build_model(MODEL), torch.Generator().manual_seed(0), LR, device="cpu",
                               db_batch_global=db_batch_global)
    checkpoints.load_state(os.path.join(work, "state0.ckpt"), state)
    if rank() == 1:
        # Rank 1 drifts: replicate must bring back rank 0's state exactly.
        with torch.no_grad():
            for t in list(state.model.parameters()) + list(state.model.buffers()):
                t.add_(1)
            for s in state.optimizer.state.values():
                s["exp_avg"].add_(1)
                s["step"].add_(3)
        state.step = 3
    return replicate(state, data_group())


def run_steps(work, out):
    group = data_group()
    batches = {}
    for name in ("batch", "batch8", "batch8_quiet"):
        with np.load(os.path.join(work, f"{name}.npz")) as z:
            batches[name] = shard_batch({k: torch.from_numpy(z[k]) for k in z.files}, group)
    batch = batches["batch"]
    for name, (bn_mode, which, accum_steps, db_batch_global) in SCENARIOS.items():
        state = fresh_state(work, db_batch_global)
        patch = FAULTS.get(name)
        real = getattr(patch[0], patch[1]) if patch else None
        if patch:
            setattr(patch[0], patch[1], patch[2])
        try:
            step = steps.make_train_step(accum_steps=accum_steps, bn_mode=bn_mode, group=group)
            state, metrics = step(state, batches[which])
        finally:
            if patch:
                setattr(patch[0], patch[1], real)
        checkpoints.save_state(os.path.join(out, f"{name}_rank{rank()}.ckpt"), state)
        params = dict(state.model.named_parameters())
        grads = {}
        for tname, coll, path, layout in avc_leaves(MODEL):
            if coll == "params":
                g = params[tname].grad.detach().double().numpy()
                g = g.transpose(2, 3, 1, 0) if layout == "conv" else g.T if layout == "dense" else g
                grads["/".join(path)] = g
        np.savez(os.path.join(out, f"{name}_rank{rank()}.npz"),
                 **{f"grad:{k}": v for k, v in grads.items()},
                 **{f"metric:{k}": float(v) for k, v in metrics.items()})
    state = fresh_state(work)
    m = steps.make_eval_step(group)(state, batch)
    np.savez(os.path.join(out, f"eval_rank{rank()}.npz"), **{k: float(v) for k, v in m.items()})


# ---------------------------------------------------------------- train()

def run_train(work, out):
    train_dir, valid_dir = os.path.join(work, "train_h5"), os.path.join(work, "valid_h5")
    seen = {}
    real_run_epochs = loop.run_epochs

    def run_epochs(state, *args, **kwargs):
        history, preempted = real_run_epochs(state, *args, **kwargs)
        seen.update(step=state.step, preempted=preempted)
        return history, preempted

    loop.run_epochs = run_epochs
    record = {}
    for name, kwargs in (
        ("uninterrupted", dict(output_dir=os.path.join(out, "u"))),
        # Only rank 1 is told to stop: both must stop at the same step.
        ("preempted", dict(output_dir=os.path.join(out, "p"),
                           preempt_after_steps=1 if rank() == 1 else None)),
        ("resumed", dict(output_dir="unused")),
    ):
        if name == "resumed":
            p_dir = record["preempted"]["model_dir"]
            if rank() == 0:  # kept for the refusal on another process count
                shutil.copytree(p_dir, os.path.join(out, "p_copy"))
            dist.barrier()
            kwargs["continue_model_dir"] = p_dir
        seen.clear()
        with WriteLog() as log:
            model_dir, history = loop.train(train_dir, valid_dir, **kwargs, **TRAIN_ARGS)
        record[name] = dict(model_dir=model_dir, history={k: history[k] for k in
                                                         ("loss", "acc", "val_loss", "val_acc")},
                            writes=log.paths, **seen)
    with open(os.path.join(out, f"train_rank{rank()}.json"), "w") as f:
        json.dump(record, f)


def main():
    work = sys.argv[1]
    torch.set_num_threads(1)
    assert initialize_distributed(), "the worker runs under RANK / WORLD_SIZE"
    out = os.path.join(work, "out")
    os.makedirs(out, exist_ok=True)
    run_steps(work, out)
    run_train(work, out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
