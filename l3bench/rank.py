"""One rank of a cell on several cards, as ``l3bench.run`` starts it under
``torch.distributed.run``; rank 0 writes the run's result to ``--out``.

    python3 -m torch.distributed.run --standalone --nproc-per-node <chips> \\
        -m l3bench.rank --workload <cell> --seed <n> --seconds <s> --trace <0|1> --t0 <time> --out <file>
"""

from __future__ import annotations

import argparse
import json
import sys

from l3bench import run


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--t0", type=float, required=True, help="time.time() when the run started")
    parser.add_argument("--out", required=True)
    parser.add_argument("--device", default="cuda", help="cpu only in the tests")
    parser.add_argument("--overrides", default="{}", help="JSON: a run resized for the tests on the CPU")
    parser.add_argument("--plant", default=None, help="module:function that breaks the program (the tests)")
    args = parser.parse_args(argv)
    run.caches()
    result = run.measure(args.workload, args.seed, args.seconds, bool(args.trace), device=args.device, t0=args.t0,
                         overrides=json.loads(args.overrides), plant=args.plant)
    if result is not None:
        with open(args.out, "w") as f:
            json.dump(result, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
