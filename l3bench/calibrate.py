"""Read the numbers that ``correct`` compares, over many seeds in one
process, for setting a cell's limits: the program's, and beside them the
control's or a planted fault's.

    python3 -m l3bench.calibrate --workload <cell> --seeds 1,2,3 \\
        [--seconds 3] [--warmup-s 0] [--controls fp8 [--control-seeds 2]] \\
        [--plant l3bench.tests.faults:half_batch=4,5,6 ...]

A cell on several cards runs it in every rank:

    python3 -m torch.distributed.run --standalone --nproc-per-node 4 -m l3bench.calibrate ...

Each seed runs the cell's set-up, a short window at the cell's own load and
the check, as a benchmark run does, and prints one JSON line: the numbers,
the controls' numbers and whether the cell's present limits pass them. The
controls are "fp8", "int8", "tf32" (the reference in that precision, put
in the program's place) and "int8prog" (the program's own int8 extraction,
for a bf16 extraction cell), read on the first `--control-seeds` seeds
(default: all); the planted runs follow the program's, in the order given.
A training cell's ranks are joined once for all of them. The benchmark's
own runs never run this.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

from l3bench import run


def main(argv=None) -> int:
    from l3bench import check, context

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated seeds")
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--controls", default="", help="comma-separated: fp8, int8, tf32, int8prog")
    parser.add_argument("--control-seeds", type=int, default=None, help="read the controls on this many seeds")
    parser.add_argument("--plant", action="append", default=[], help="module:function=seed,seed,...")
    parser.add_argument("--warmup-s", type=float, default=None, help="in place of the cell's warm-up")
    args = parser.parse_args(argv)
    run.caches()
    _, entry, cell, config, mix = run.load_cell(args.workload)
    if args.warmup_s is not None:
        cell = {**cell, "warmup_s": args.warmup_s}
    driver = importlib.import_module(f"l3bench.drivers.{cell['driver']}")
    controls = tuple(c for c in args.controls.split(",") if c)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    n_ctl = len(seeds) if args.control_seeds is None else args.control_seeds
    jobs = [(seed, None, controls if i < n_ctl else ()) for i, seed in enumerate(seeds)]
    for spec in args.plant:
        plant, _, planted = spec.partition("=")
        jobs += [(int(s), plant, ()) for s in planted.split(",") if s]
    ctxs = [context.Context(cell=cell, config=config, mix=mix, seed=seed, seconds=args.seconds, trace=False,
                            device="cuda", t0=time.time(), world=entry["chips"], controls=ctl, plant=plant)
            for seed, plant, ctl in jobs]
    t = [time.time()]

    def report(i, record):
        numbers = record["numbers"]
        ok, _ = check.verdict(numbers, cell["check"]["limits"])
        print(json.dumps({"workload": args.workload, "seed": jobs[i][0], "plant": jobs[i][1], "passes": ok,
                          "failed": record["failed"], "seconds": time.time() - t[0],
                          "memory_peak_bytes": record.get("memory_peak_bytes"), "numbers": numbers},
                         default=str), flush=True)
        t[0] = time.time()

    if hasattr(driver, "run_many"):
        driver.run_many(ctxs, report)
    else:
        for i, ctx in enumerate(ctxs):
            report(i, driver.run(ctx))
    return 0


if __name__ == "__main__":
    sys.exit(main())
