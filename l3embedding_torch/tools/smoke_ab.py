"""Run ``chip_smoke.py`` of two checkouts of this repo on one card, in the
order A, B, B, A, each in a process of its own, and sum up the end-to-end
numbers of each run.

    python -m l3embedding_torch.tools.smoke_ab DIR_A DIR_B --out DIR

Each run starts ``python3 chip_smoke.py`` from its checkout (which builds
its kernels there) and writes the whole output to ``DIR/smoke_<run>.log``
(A1, B1, B2, A2). Then one JSON line per run gives its exit code, the
extraction rates (windows/s by model type, mode and pooling), the AVC
forward times (ms at batch 8 by model type and mode) and its kernels line.
Exits nonzero if a run failed.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

_RATE = re.compile(r"^extractor (\S+) fast=(\w+) (\w+): ([0-9.]+) windows/s$", re.M)
_AVC = re.compile(r"^avc (\S+) fast=(\w+): .* forward ([0-9.]+) ms at batch", re.M)


def summary(text: str) -> dict:
    """The end-to-end numbers and the kernels line of one smoke's output."""
    kernels = [json.loads(line) for line in text.splitlines() if line.startswith('{"kernels"')]
    return {
        "windows_per_s": {f"{m} fast={f} {p}": float(r) for m, f, p, r in _RATE.findall(text)},
        "avc_forward_ms": {f"{m} fast={f}": float(ms) for m, f, ms in _AVC.findall(text)},
        "kernels": kernels[-1]["kernels"] if kernels else None,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs=2, help="two checkouts of the repo: A B")
    ap.add_argument("--out", required=True, help="directory for the runs' whole output")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    a, b = (os.path.abspath(t) for t in args.trees)
    failed = 0
    for run, tree in (("A1", a), ("B1", b), ("B2", b), ("A2", a)):
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tree, capture_output=True,
                              text=True, env={**os.environ, "PYTHONPATH": tree})
        with open(os.path.join(args.out, f"smoke_{run}.log"), "w") as f:
            f.write(proc.stdout + proc.stderr)
        failed += proc.returncode != 0
        print(json.dumps({"run": run, "tree": tree, "rc": proc.returncode, **summary(proc.stdout)}),
              flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
