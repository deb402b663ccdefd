"""Time the front-end kernels of two checkouts of this repo on one card, in
the order A, B, B, A, each run in a process of its own (or of one checkout,
run once).

    python -m l3embedding_torch.tools.frontend_ab DIR_A [DIR_B] [--sass] [--batch B]

Each run imports the ``l3embedding_torch`` of its checkout, builds the mel
and linear-spectrogram sources there, and times ``melspectrogram_fused``
(B windows, default 64, of 48000 samples, 256 mels, dB) and
``spectrogram_fused`` (B windows, cnn_L3_orig) in bf16 and f32 as
``chip_smoke.py`` does: per call back to
back between CUDA events (3 warm-up calls, 20 timed). Then the same call is
timed from a CUDA graph (20 calls replayed) and once more between events,
so that the effect of the order shows, and the host time to make one call
is taken (20 calls on the host clock, no synchronisation inside). The bf16
mel kernel is also timed in amplitude mode (no dB pass: one launch a
call), and with dB once more at the end; where the tree's bf16 kernels
choose their frames per block (64 or 128), each kernel is timed at both,
forced (its host time then includes re-making the launch constants). The card's SM clock, power draw
and temperature are read with nvidia-smi after each timing. With
``--sass`` the SASS of every kernel function in the two built libraries is
hashed (from ``cuobjdump -sass``), to tell whether a kernel's machine code
changed.

Prints one JSON line per run, then, with ``--sass``, one per kernel
function found in both checkouts' libraries, saying whether its SASS is the
same.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import time

def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def _sass_hashes(lib_path) -> dict:
    """{kernel function name: sha1 of its SASS} for one built library. The
    two hashes nvcc puts into the name of an anonymous namespace
    (_GLOBAL__N__<hash>_<len>_<file>_cu_<hash>) differ between two versions
    of a source, so both are dropped from the name; cuobjdump pads its
    columns to the longest instruction of the library, so runs of blanks
    are taken as one."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    parts = re.split(r"^\s*Function : (\S+)\s*$", text, flags=re.M)
    return {re.sub(r"_GLOBAL__N__[0-9a-f]+_(\d+_\w+?_cu)_[0-9a-f]{8}", r"_GLOBAL__N__\1", name):
            hashlib.sha1(re.sub(r"[ \t]+", " ", body.strip()).encode()).hexdigest()[:16]
            for name, body in zip(parts[1::2], parts[2::2])}


def _child(tree: str, sass: bool, batch: int) -> dict:
    """One run in the checkout `tree` (on sys.path first)."""
    import numpy as np
    import torch

    import l3embedding_torch
    from l3embedding_torch.ops import cuda_build, mel_kernel, spec_kernel
    from l3embedding_torch.ops.frontend import MelConfig, SpectrogramConfig

    def events_ms(fn, iters=20, warmup=3):
        for _ in range(warmup):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def graph_ms(fn, iters=20):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
        graph.replay()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def host_ms(fn, iters=20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) * 1e3 / iters

    torch.backends.cuda.matmul.allow_tf32 = False
    libs = {name: cuda_build.build(name) for name in ("mel_frontend", "spec_frontend")}
    rng = np.random.RandomState(0)
    pcm = (rng.randn(batch, 48000) * 0.3 * rng.uniform(0.01, 1.0, (batch, 1))).astype(np.float32)
    x = torch.from_numpy(pcm).cuda()
    mel_cfg, spec_cfg = MelConfig(n_mels=256), SpectrogramConfig()
    mel_amp = MelConfig(n_mels=256, decibel=False)
    cases = [
        ("mel_frontend_bf16", lambda: mel_kernel.melspectrogram_fused(x, mel_cfg, fast=True)),
        ("mel_frontend_bf16 amplitude", lambda: mel_kernel.melspectrogram_fused(x, mel_amp, fast=True)),
        ("mel_frontend_f32", lambda: mel_kernel.melspectrogram_fused(x, mel_cfg, fast=False)),
        ("spec_frontend_bf16", lambda: spec_kernel.spectrogram_fused(x, spec_cfg, fast=True)),
        ("spec_frontend_f32", lambda: spec_kernel.spectrogram_fused(x, spec_cfg, fast=False)),
        ("mel_frontend_bf16 last", lambda: mel_kernel.melspectrogram_fused(x, mel_cfg, fast=True)),
    ]
    from l3embedding_torch.ops import dft_stage

    if hasattr(dft_stage, "frames_per_block"):
        # Each block shape the tree's bf16 kernels take, forced.
        for frames in (64, 128):
            for what, fn, cfg in (("mel_frontend_bf16", mel_kernel.melspectrogram_fused, mel_cfg),
                                  ("spec_frontend_bf16", spec_kernel.spectrogram_fused, spec_cfg)):

                def forced(fn=fn, cfg=cfg, frames=frames):
                    choose = dft_stage.frames_per_block
                    dft_stage.frames_per_block = lambda *_: frames
                    mel_kernel._launch.cache_clear()
                    spec_kernel._launch.cache_clear()
                    try:
                        return fn(x, cfg, fast=True)
                    finally:
                        dft_stage.frames_per_block = choose
                        mel_kernel._launch.cache_clear()
                        spec_kernel._launch.cache_clear()

                cases.append((f"{what} frames={frames}", forced))
    rows = []
    for label, fn in cases:
        row = {"kernel": label}
        row["events_ms"], row["smi_after_events"] = events_ms(fn), _smi()
        row["graph_ms"], row["smi_after_graph"] = graph_ms(fn), _smi()
        row["events_again_ms"], row["smi_after_events_again"] = events_ms(fn), _smi()
        row["host_ms"] = host_ms(fn)
        rows.append(row)
    out = {"tree": tree, "package": os.path.dirname(l3embedding_torch.__file__), "batch": batch,
           "rows": rows}
    if sass:
        out["sass"] = {name: _sass_hashes(path) for name, path in libs.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", help="one checkout of the repo, or two: A B")
    ap.add_argument("--sass", action="store_true", help="compare the kernels' SASS too")
    ap.add_argument("--batch", type=int, default=64, help="windows per call (default 64)")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        sys.path.insert(0, args.child)
        print(json.dumps(_child(args.child, args.sass, args.batch)), flush=True)
        return 0
    if len(args.trees) not in (1, 2):
        ap.error("give one checkout, or two: A B")
    paths = [os.path.abspath(t) for t in args.trees]
    a, b = paths[0], paths[-1]
    order = (a, b, b, a) if len(args.trees) == 2 else (a,)
    runs = []
    for i, tree in enumerate(order):
        cmd = [sys.executable, os.path.abspath(__file__), "--child", tree, "--batch", str(args.batch)]
        if args.sass and i < 2:
            cmd.append("--sass")
        env = {**os.environ, "PYTHONPATH": tree}
        proc = subprocess.run(cmd, cwd=tree, env=env, capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"run {i} in {tree} failed ({proc.returncode})")
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"run": i, "which": "AB"[tree == b], **{k: run[k] for k in ("tree", "package", "batch", "rows")}}),
              flush=True)
        runs.append(run)
    if args.sass and len(runs) > 1:
        for lib in runs[0]["sass"]:
            ha, hb = runs[0]["sass"][lib], runs[1]["sass"].get(lib, {})
            for fn in sorted(set(ha) & set(hb)):
                print(json.dumps({"library": lib, "function": fn, "sass_same": ha[fn] == hb[fn]}))
            print(json.dumps({"library": lib, "only_in_A": sorted(set(ha) - set(hb)),
                              "only_in_B": sorted(set(hb) - set(ha))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
