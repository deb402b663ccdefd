"""Run one cell of the benchmark of ``l3embedding_torch`` once.

    python3 -m l3bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is an entry of ``workloads`` in
``BENCHMARK.json``; everything else is found by name:
``l3bench/cells/<cell>.json`` (the driver, the precision, the options, the
warm-up, the traced stretch, the limits of the check),
``l3bench/configs/<config>.json``, ``l3bench/traffic/<mix>.json`` and one
reader a metric, ``l3bench/metrics/<metric>.py``. A one-card cell runs in
this process; a cell on several cards runs its ranks under
``torch.distributed.run`` (``l3bench/rank.py``), and this process waits
for them and prints what rank 0 found. With ``--trace 0`` the run reports
the cell's end-to-end metrics, with ``--trace 1`` its per-layer ones. The
last line of standard output is the result as one JSON object; the numbers
compared with the reference, each beside its limit, are the last lines of
standard error and the last key of that object.

The run exits with another code than 0, and prints no result, without
enough CUDA cards for the cell, or when a process of the run holds a module
of JAX, flax or the JAX package once the window has closed.
"""

from __future__ import annotations

import time

T0 = time.time()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / "l3bench_cache"
# The bytecode of every module a run imports, torch's among them, is cached
# at a fixed directory inside the checkout, so that only a checkout's first
# run compiles it: an installation that holds no bytecode, under
# PYTHONDONTWRITEBYTECODE, would otherwise have every run compile torch's
# sources anew (some seconds of set-up, as fast as the shared host's CPU).
sys.pycache_prefix = str(CACHE / "pyc")
sys.dont_write_bytecode = False

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402
import tempfile  # noqa: E402

RANKS_TIMEOUT_S = 1150  # a multi-card run's ranks, the first run of a checkout's builds included


def caches() -> None:
    """Every build and kernel cache, and the bytecode, at fixed directories
    inside the checkout, for this process and the ones it starts; and no
    library loads JAX by itself."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    os.environ["PYTHONPYCACHEPREFIX"] = str(CACHE / "pyc")
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str) -> tuple[dict, dict, dict, dict, dict]:
    """(BENCHMARK.json, its workload entry, the cell, the configuration, the
    traffic mix) of cell `name`."""
    from l3bench import generate

    bench = load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"unknown workload {name!r}")
    cell = load_json(HERE / "cells" / f"{name}.json")
    config = load_json(HERE / "configs" / f"{entry['config']}.json")
    return bench, entry, cell, config, generate.load_mix(entry["traffic"])


def cell_metrics(bench: dict, name: str, trace: bool) -> list[dict]:
    """The metrics the cell reports: its end-to-end metrics untraced, its
    per-layer metrics traced."""
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}

    def reports(m):
        return name in m["workloads"] if "workloads" in m else m["moves"] in moved

    return [m for m in bench["per_layer"] if reports(m)]


def reader(metric: str):
    spec = importlib.util.spec_from_file_location(f"l3bench_metric_{metric}", HERE / "metrics" / f"{metric}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _number(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else "inf"


def measure(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda", t0: float = T0,
            overrides: dict | None = None, plant: str | None = None, marks: tuple = ()) -> dict | None:
    """One run of the cell in this process (or in this rank) → the result
    object, without printing it; None on a rank other than 0.
    `overrides` ({"cell": {...}, "mix": {...}, "world": n}) resize a run
    for the tests on the CPU; `plant` breaks the program (the tests'
    faults); `marks` are the set-up's phases before the driver."""
    from l3bench import check, context
    from l3bench.traces import breakdown

    bench, entry, cell, config, mix = load_cell(workload)
    overrides = overrides or {}
    cell = {**cell, **overrides.get("cell", {})}
    mix = {**mix, **overrides.get("mix", {})}
    world = int(overrides.get("world", entry["chips"]))
    ctx = context.Context(cell=cell, config=config, mix=mix, seed=int(seed), seconds=float(seconds),
                          trace=bool(trace), device=device, t0=t0, world=world, plant=plant, marks=tuple(marks))
    driver = importlib.import_module(f"l3bench.drivers.{cell['driver']}")
    record = driver.run(ctx)
    if record is None:
        return None

    rec = {**record, "cell": cell, "config": config, "mix": mix, "chips": world}
    metrics = {}
    for m in cell_metrics(bench, workload, trace):
        value = reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    ok, table = check.verdict(record["numbers"], cell["check"]["limits"])
    ok = ok and record["attempted"] > 0 and record["failed"] == 0
    result = {"correct": bool(ok), "attempted": record["attempted"], "failed": record["failed"],
              "metrics": metrics, "device": _device(device, world, record)}
    if trace and record.get("trace"):
        result["device"]["busy_s"] = record["trace"]["busy_s"]
        result["device"]["window_s"] = record["trace"]["stretch_s"]
        result["breakdown"] = breakdown(record["trace"])
    # Not printed in the result line: set-up's phases and the cards' clocks
    # go to standard error, the modules look to the printing process.
    result["setup_phases"] = record["setup_phases"]
    result["gpus"] = record.get("gpus")
    result["forbidden"] = record.get("forbidden", [])
    result["checks"] = {k: {"value": _number(v["value"]), "limit": v["limit"]} for k, v in table.items()}
    return result


def _device(device: str, world: int, record: dict) -> dict:
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": world, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": world,
            "memory_peak_bytes": int(record["memory_peak_bytes"])}


def launch_ranks(args, chips: int, extra: tuple = ()) -> dict:
    """Run the cell's ranks under torch.distributed.run, one a card, and
    → rank 0's result. Their output goes to this process's standard error;
    every process they start is ended before this returns. `extra`: more
    arguments of ``l3bench.rank`` (the tests')."""
    tmp = Path(tempfile.mkdtemp(prefix="l3bench-"))
    out = tmp / "result.json"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nnodes", "1",
           "--nproc-per-node", str(chips), "-m", "l3bench.rank", "--workload", args.workload,
           "--seed", str(args.seed), "--seconds", str(args.seconds), "--trace", str(args.trace),
           "--t0", repr(T0), "--out", str(out), *extra]
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=sys.stderr, start_new_session=True)
    try:
        rc = proc.wait(timeout=RANKS_TIMEOUT_S)
    except BaseException:
        for sig, wait in ((signal.SIGTERM, 30), (signal.SIGKILL, None)):
            try:
                os.killpg(proc.pid, sig)
                proc.wait(timeout=wait)
                break
            except (ProcessLookupError, subprocess.TimeoutExpired):
                continue
        raise
    finally:
        result = load_json(out) if out.exists() else None
        shutil.rmtree(tmp, ignore_errors=True)
    if rc != 0 or result is None:
        raise SystemExit(f"l3bench: the ranks of {args.workload} failed (torch.distributed.run exit code {rc})")
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    caches()

    _, entry, *_ = load_cell(args.workload)
    import torch

    from l3bench.context import loaded_forbidden

    marks = [("torch imported", time.time() - T0)]
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"l3bench: {args.workload} needs {entry['chips']} CUDA card(s); "
              f"available: {torch.cuda.is_available()}, count: {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    marks.append(("cards counted", time.time() - T0))
    if entry["chips"] == 1:
        result = measure(args.workload, args.seed, args.seconds, bool(args.trace), marks=tuple(marks))
    else:
        result = launch_ranks(args, entry["chips"])
        result["setup_phases"] = marks + result["setup_phases"]
    bad = sorted(set(loaded_forbidden()) | set(result.pop("forbidden")))
    if bad:
        print(f"l3bench: modules of JAX or the JAX package are loaded: {bad[:10]}", file=sys.stderr)
        return 3
    print(result_line(result), flush=True)
    return 0


def result_line(result: dict) -> str:
    """Print set-up's phases, the cards' clocks and each number compared
    beside its limit, as the last lines of standard error; → the result
    line, whose last key is the same numbers."""
    print("set-up, seconds from the start at the end of each phase: "
          + ", ".join(f"{name} {t:.3f}" for name, t in result.pop("setup_phases")), file=sys.stderr)
    gpus = result.pop("gpus", None)
    if gpus:
        print(f"cards before the window: {gpus['before']} | after it: {gpus['after']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    return json.dumps(result)

if __name__ == "__main__":
    sys.exit(main())
