"""Time the block-1 kernels of two checkouts of this repo on one card, in the
order A, B, B, A, each run in a process of its own (or of one checkout, run
once).

    python -m l3embedding_torch.tools.block1_ab DIR_A [DIR_B] [--steps 20]

Each run imports the ``l3embedding_torch`` of its checkout, builds its
``block1_conv`` source there and times, on ``chip_smoke.py``'s seeded
inputs:

  * the GEMM probe (3584 × 576, reps 64) at N = 64 and 128, from a CUDA
    graph of ``steps`` calls and per call between CUDA events;
  * the fused conv at the vision (128, 224, 224, 64) and audio
    (128, 257, 197, 64) conv1_2 shapes, per call between CUDA events (3
    warm-up calls, ``steps`` timed), and then over 200 calls back to back,
    long enough for the card to reach its power limit;
  * beside the conv, the library calls of the same run: cuDNN's bf16
    channels-last conv alone, the one-call ``torch.cudnn_convolution_relu``
    (W·scale folded into bf16 weights, shift as the bias) and the conv with
    its eager f32 epilogue (``block1_spike.cudnn_conv_bn_relu``).

Every time carries the card's SM clock, power draw and temperature as
nvidia-smi reads them just after it, and each shape its bound (operations
at 989 TFLOP/s bf16 or bytes at 3.35 TB/s, the larger). Prints one JSON
line per run.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

PEAK_BF16_TC, PEAK_HBM = 989e12, 3.35e12
CONV_SHAPES = {"vision": (128, 224, 224), "audio": (128, 257, 197)}


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def _bound_ms(flops: float, bytes_: float) -> float:
    return max(flops / PEAK_BF16_TC, bytes_ / PEAK_HBM) * 1e3


def _child(steps: int) -> dict:
    import torch

    from l3embedding_torch.ops import block1_kernel as bk
    from l3embedding_torch.ops import cuda_build
    from l3embedding_torch.tools import block1_spike

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda_build.build("block1_conv")

    def events_ms(fn, iters=steps, warmup=3):
        for _ in range(warmup):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return {"ms": start.elapsed_time(end) / iters, "smi": _smi()}

    def graph_ms(fn):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(steps):
                fn()
        graph.replay()
        timed = events_ms(graph.replay, iters=1, warmup=0)
        return {**timed, "ms": timed["ms"] / steps}

    out = {}
    for n_out in (64, 128):
        a, w, s, b = block1_spike.gemm_operands(n_out, torch.device("cuda"))
        m, k = a.shape
        out[f"gemm_n{n_out}"] = {
            "graph": graph_ms(lambda: bk.gemm_probe(a, w, s, b, 64)),
            "events": events_ms(lambda: bk.gemm_probe(a, w, s, b, 64)),
            "bound_ms": _bound_ms(2.0 * m * k * n_out * 64, (m * k + k * n_out + m * n_out) * 2 + 2 * n_out * 4),
        }
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, (batch, h, wd) in CONV_SHAPES.items():
        x = (torch.randn(batch, h, wd, 64, device="cuda", generator=gen) * 0.1).to(torch.bfloat16)
        wt = (torch.randn(576, 64, device="cuda", generator=gen) * 0.05).to(torch.bfloat16)
        scale = torch.rand(64, device="cuda", generator=gen) + 0.5
        shift = torch.randn(64, device="cuda", generator=gen) * 0.1
        w_cl = wt.reshape(3, 3, 64, 64).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        w_folded = (w_cl.float() * scale[:, None, None, None]).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        shift_bf16, xc = shift.to(torch.bfloat16), x.permute(0, 3, 1, 2)
        n_px = batch * h * wd
        row = {"kernel": events_ms(lambda: bk.conv3x3_bn_relu(x, wt, scale, shift)),
               "bound_ms": _bound_ms(2.0 * n_px * 576 * 64, 2 * n_px * 64 * 2 + 576 * 64 * 2 + 2 * 64 * 4)}
        with torch.backends.cudnn.flags(enabled=True, benchmark=True, allow_tf32=False):
            row["cudnn_conv"] = events_ms(lambda: torch.nn.functional.conv2d(xc, w_cl, padding=1))
            try:
                row["cudnn_convolution_relu"] = events_ms(lambda: torch.cudnn_convolution_relu(
                    xc, w_folded, shift_bf16, [1, 1], [1, 1], [1, 1], 1))
            except RuntimeError as e:
                row["cudnn_convolution_relu"] = {"refused": repr(e)[:300]}
            row["cudnn_conv_eager_epilogue"] = events_ms(
                lambda: block1_spike.cudnn_conv_bn_relu(x, w_cl, scale, shift))
        row["kernel_sustained"] = events_ms(lambda: bk.conv3x3_bn_relu(x, wt, scale, shift), iters=200, warmup=0)
        out[f"conv_{name}"] = row
        del x, xc
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", help="one checkout of the repo, or two: A B")
    ap.add_argument("--steps", type=int, default=20, help="timed calls per measurement (default 20)")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        sys.path.insert(0, args.child)
        print(json.dumps(_child(args.steps)), flush=True)
        return 0
    if len(args.trees) not in (1, 2):
        ap.error("give one checkout, or two: A B")
    paths = [os.path.abspath(t) for t in args.trees]
    a, b = paths[0], paths[-1]
    for i, tree in enumerate((a, b, b, a) if len(paths) == 2 else (a,)):
        cmd = [sys.executable, os.path.abspath(__file__), "--child", tree, "--steps", str(args.steps)]
        proc = subprocess.run(cmd, cwd=tree, env={**os.environ, "PYTHONPATH": tree},
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"run {i} in {tree} failed ({proc.returncode})")
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"run": i, "which": "AB"[tree == b], "tree": tree, **run}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
