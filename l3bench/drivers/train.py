"""Driver of the training cells: the AVC train step of
``training/steps.py::make_train_step(bn_mode="sync")`` driven as
``training/loop.py::run_epochs`` drives it.

The batches are a pool made on the card during set-up and cycled, so the
window measures the step and not the feed. On several cards the run's
processes are the ranks that ``torch.distributed.run`` started, one a
card; they join over NCCL through ``parallel.initialize_distributed``, and
each keeps its rows of every global batch (``parallel.shard_batch``) on its
card. As ``run_epochs`` does, the window keeps up to ``max(2, 2 x
prefetch)`` steps in flight and reads the oldest step's loss, and on
several cards polls ``loop._PreemptionSync`` after every step: rank 0's
"time is up" goes through the lagged MAX all-reduce, so that every rank
stops after the same step. The window starts after a synchronise and a
barrier on every rank, and is timed on rank 0.

Set-up builds one train state from the seed, drives it through its first
three steps on the pool's first three batches (the checked steps), then
steps on for at least ``warmup_s`` seconds and until the time of a group of
steps is steady, so that the cards' clocks have settled under the load, and
hands the same state to the window. The check runs after the window on rank
0, once every rank has freed its state: the plain reference repeats the
three steps on the whole global batches, their rows spread over the run's
cards.
"""

from __future__ import annotations

import math
import os
import subprocess
import time
from collections import deque

import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile, record_function

from .. import check, generate, traces, weights
from ..context import loaded_forbidden, resolve
from ..reference import model as ref
from . import _port

CHECKED_STEPS = 3
GROUP_STEPS = 4  # warm-up steps a timing group
STEADY = 0.01  # warm-up ends once a group's time is within this share of the last one's


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _gpus() -> str:
    """Each card's SM clock and power draw, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=index,clocks.sm,power.draw,temperature.gpu",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return "; ".join(line.strip() for line in out.stdout.splitlines())


def run(ctx) -> dict | None:
    records = run_many([ctx])
    return records[0] if records else None


def run_many(ctxs: list, on_record=None) -> list | None:
    """One record a context, in order, from one set of ranks joined once
    (the calibration reads many seeds so); `on_record(i, record)` sees each
    as rank 0 finishes it. On several cards every rank calls this; rank 0
    returns the records, the others None."""
    from l3embedding_torch import parallel

    ctx = ctxs[0]
    cuda = torch.device(ctx.device).type == "cuda"
    phases = [*ctx.marks]
    group = flags = None
    rank = 0
    if ctx.world > 1:
        if int(os.environ.get("WORLD_SIZE", "1")) != ctx.world:
            raise RuntimeError(f"the cell needs {ctx.world} ranks started by torch.distributed.run")
        parallel.initialize_distributed(backend="nccl" if cuda else "gloo")
        rank = dist.get_rank()
        group = parallel.data_group()
        flags = dist.new_group(backend="gloo")  # warm-up timing, records, barriers: on the host
        phases.append(("process group", time.time() - ctx.t0))
    device = parallel.local_device("cuda") if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(device)
    records = []
    try:
        for i, c in enumerate(ctxs):
            record = _one(c, rank, device, group, flags, phases if i == 0 else [])
            if rank == 0:
                records.append(record)
                if on_record is not None:
                    on_record(i, record)
    finally:
        if flags is not None:
            dist.destroy_process_group()
    return records if rank == 0 else None


def _one(ctx, rank: int, device, group, flags, phases: list) -> dict | None:
    from l3embedding_torch import parallel
    from l3embedding_torch.models.registry import build_model
    from l3embedding_torch.training.state import TrainState, make_optimizer
    from l3embedding_torch.training.steps import make_train_step

    cell, cfg, mix = ctx.cell, ctx.config, ctx.mix
    specs = ref.param_specs(cfg)
    params0 = weights.make(specs, ctx.seed, str(device))
    phases.append(("imports, CUDA context and weights", time.time() - ctx.t0))
    dtype = torch.bfloat16 if cell["precision"] == "bf16" else torch.float32
    model = build_model(cfg["model_type"]).module(dtype).to(device)
    _port.load(model, params0)
    phases.append(("model", time.time() - ctx.t0))
    opt = make_optimizer(model, cfg["adam"]["learning_rate"])
    state = TrainState(0, model, opt, cfg["model_type"])
    step = make_train_step(bn_mode="sync", group=group)
    if ctx.plant:
        step = resolve(ctx.plant)(step)
    phases.append(("optimizer and step", time.time() - ctx.t0))

    pool = []
    for batch in generate.generator(mix).avc_pool(mix, ctx.seed, device, ctx.world):
        pool.append({k: v.clone() for k, v in parallel.shard_batch(batch, group).items()})
        del batch
    phases.append(("batch pool", time.time() - ctx.t0))

    record = _steps(ctx, rank, device, group, flags, state, step, pool, phases)
    del state, model, opt, step, pool
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if rank != 0:
        dist.barrier(group=flags)  # rank 0's check, on the cards of every rank
        return None
    record["numbers"] = _check(ctx, record.pop("program"), params0)
    if flags is not None:
        dist.barrier(group=flags)
    return record


def _agree(x: float, flags, op=None) -> float:
    """x reduced over the ranks on the host (MAX), so every rank decides alike."""
    if flags is None:
        return x
    t = torch.tensor([x], dtype=torch.float64)
    dist.all_reduce(t, op=op or dist.ReduceOp.MAX, group=flags)
    return float(t)


def _steps(ctx, rank, device, group, flags, state, step, pool, phases) -> dict:
    from l3embedding_torch.training.loop import _PreemptionSync

    cuda = device.type == "cuda"
    cfg, cell = ctx.config, ctx.cell
    b1 = cfg["adam"]["b1"]
    opt, model = state.optimizer, state.model
    trainable = [name for name, *_ in ref.param_specs(cfg) if not ref.is_running_stat(name)]

    # The checked steps: the loss of each, the towers' output rows in the
    # first (this rank's), the first gradient from Adam's first moment after
    # one step, the leaves as the fourth step gets them.
    program = {"loss": [], "emb1": {}}
    for i in range(CHECKED_STEPS):
        hooks = _tower_hooks(model, program["emb1"]) if i == 0 else []
        state, metrics = step(state, pool[i])
        for h in hooks:
            h.remove()
        program["loss"].append(float(metrics["loss"] + metrics["reg_loss"]))
        if i == 0:
            program["grad1"] = {n: _first_moment(opt, model.get_parameter(_port.port_name(n))) / (1 - b1)
                                for n in trainable}
    program["params"] = _port.read(model, [name for name, *_ in ref.param_specs(cfg)])
    phases.append(("checked steps", time.time() - ctx.t0))

    # Warm-up until the step time is steady: groups of steps, each timed to
    # its last loss, the slowest rank's time deciding on every rank.
    n = CHECKED_STEPS
    t_warm = time.perf_counter()
    times = []
    while True:
        t_g = time.perf_counter()
        for _ in range(GROUP_STEPS):
            state, metrics = step(state, pool[n % len(pool)])
            n += 1
        float(metrics["loss"])
        times.append(_agree(time.perf_counter() - t_g, flags))
        elapsed = _agree(time.perf_counter() - t_warm, flags)
        steady = len(times) > 1 and abs(times[-1] - times[-2]) <= STEADY * times[-2]
        if (elapsed >= cell["warmup_s"] and steady) or elapsed >= 3 * cell["warmup_s"]:
            break
    phases.append((f"warm-up, {n - CHECKED_STEPS} steps, groups of {GROUP_STEPS} in "
                   + " ".join(f"{t:.3f}" for t in times) + " s", time.time() - ctx.t0))

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if ctx.trace:  # the profiler's own first start, outside the window
        with profile(activities=activities):
            state, metrics = step(state, pool[n % len(pool)])
            n += 1
            float(metrics["loss"])
        phases.append(("profiler's first start", time.time() - ctx.t0))
    gpus_before = _gpus() if cuda and rank == 0 else ""
    _sync(device)
    if flags is not None:
        dist.barrier(group=flags)
    setup_s = time.time() - ctx.t0

    tr = cell["trace"]
    trace_from, trace_to = (tr["start"], tr["start"] + tr["units"]) if ctx.trace else (-1, -1)
    max_inflight = max(2, 2 * int(ctx.mix["prefetch"]))
    t_start = time.perf_counter()
    t_stop = t_start + ctx.seconds
    psync = _PreemptionSync(lambda: rank == 0 and time.perf_counter() >= t_stop, group, lag=max_inflight)
    inflight, losses, enqueue = deque(), [], []
    prof = span = None
    tracing = False
    steps = 0
    try:
        while True:
            if steps == trace_from:
                _sync(device)
                prof = profile(activities=activities)
                prof.start()
                span = record_function(traces.STRETCH)
                span.__enter__()
                tracing = True
            batch = pool[(n + steps) % len(pool)]
            t_a = time.perf_counter()
            with record_function("train.step"):
                state, metrics = step(state, batch)
            if not tracing:
                enqueue.append(time.perf_counter() - t_a)
            inflight.append(metrics["loss"])
            if len(inflight) > max_inflight:
                with record_function("train.read_loss"):
                    losses.append(float(inflight.popleft()))
            steps += 1
            if steps == trace_to:
                _sync(device)
                span.__exit__(None, None, None)
                prof.stop()
                tracing = False
            with record_function("train.poll"):
                if psync.poll():
                    break
        losses += [float(x) for x in inflight]
        _sync(device)
        t_end = time.perf_counter()
    finally:
        psync.close()
    if tracing:
        span.__exit__(None, None, None)
        prof.stop()
    gpus_after = _gpus() if cuda and rank == 0 else ""

    rank_rec = {"peak": torch.cuda.max_memory_allocated(device) if cuda else None,
                "trace": traces.reduce(prof) if prof is not None else None,
                "emb1": program.pop("emb1"), "enqueue": enqueue, "forbidden": loaded_forbidden()}
    ranks = [rank_rec]
    if flags is not None:
        gathered = [None] * ctx.world if rank == 0 else None
        dist.gather_object(rank_rec, gathered, dst=0, group=flags)
        if rank != 0:
            return {}
        ranks = gathered
    # The global batch's rows, in rank order as shard_batch cut them.
    program["emb1"] = {t: torch.cat([r["emb1"][t] for r in ranks]) for t in ranks[0]["emb1"]}
    enq = [x for r in ranks[:1] for x in r["enqueue"]]
    record = {
        "setup_s": setup_s,
        "setup_phases": phases,
        "window_s": t_end - t_start,
        "attempted": steps,
        "failed": sum(not math.isfinite(x) for x in losses),
        "pairs": steps * generate.generator(ctx.mix).global_rows(ctx.mix, ctx.world),
        "enqueue_s": sum(enq) / len(enq) if enq else None,
        "traced_steps": max(0, min(steps, trace_to) - trace_from) if ctx.trace else 0,
        "trace": None,
        "rank_traces": [],
        "gpus": {"before": gpus_before, "after": gpus_after},
        "forbidden": sorted({m for r in ranks for m in r["forbidden"]}),
        "program": program,
    }
    if cuda:
        record["memory_peak_bytes"] = max(r["peak"] for r in ranks)
    rank_traces = [r["trace"] for r in ranks if r["trace"] is not None]
    if rank_traces:
        record["trace"] = traces.merge(rank_traces)
        record["rank_traces"] = [r["trace"] for r in ranks]
    return record


def _tower_hooks(model, out: dict) -> list:
    """Hooks that keep each tower's first output of a step in `out`, on the
    host (a tower recomputed in the backward runs twice)."""

    def keep(name):
        def hook(module, args, y):
            out.setdefault(name, y.detach().float().cpu())
        return hook

    return [getattr(model, f"{name}_model").register_forward_hook(keep(name)) for name in ("vision", "audio")]


def _first_moment(opt, p) -> torch.Tensor:
    """Adam's first moment of p on the host; zeros where the optimizer holds
    none (it never took a step)."""
    m = opt.state.get(p, {}).get("exp_avg")
    return (m if m is not None else torch.zeros_like(p)).detach().float().cpu()


def _check(ctx, program: dict, params0: dict) -> dict:
    """The reference's three steps on the whole global batches, from the
    harness's initial leaves, their rows spread over the run's cards,
    against the program's."""
    home = params0[next(iter(params0))].device
    devices = ([torch.device("cuda", i) for i in range(ctx.world)] if home.type == "cuda" else [home])
    batches = generate.generator(ctx.mix).avc_pool(ctx.mix, ctx.seed, home, ctx.world,
                                                   keep=range(CHECKED_STEPS))
    base = {k: v.cpu() for k, v in params0.items()}

    def on_host(out):
        return {"loss": out["loss"], "grad1": {k: v.cpu() for k, v in out["grad1"].items()},
                "emb1": out["emb1"], "params": {k: v.cpu() for k, v in out["params"].items()}}

    want = on_host(ref.train_steps(params0, batches, ctx.config, "f32", devices))
    numbers = check.train_numbers(program, want, base)
    numbers["program_loss"], numbers["reference_loss"] = program["loss"], want["loss"]
    if ctx.controls:
        numbers["controls"] = {}
        for prec in ctx.controls:
            got = on_host(ref.train_steps(params0, batches, ctx.config, prec, devices))
            c = check.train_numbers(got, want, base)
            numbers["controls"][prec] = {k: v for k, v in c.items() if k != "left_out"}
    # The other ranks' cards hold what the reference cached there: give it
    # back before the next seed of a calibration steps on them.
    del batches
    for d in devices[1:]:
        with torch.cuda.device(d):
            torch.cuda.empty_cache()
    return numbers
