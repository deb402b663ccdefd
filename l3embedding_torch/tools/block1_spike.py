"""Block-1 go/no-go probe on the card: hand-written Hopper kernels for the
64-channel block-1 conv against cuDNN.

The PyTorch counterpart of ``tools/pallas_block1_spike.py``, on its shape:
vision ``conv1_2``, (B, 224, 224, 64) → (B, 224, 224, 64), bf16.

  cudnn — the library yardstick: cuDNN's bf16 conv on channels-last x
          (autotuned), then ·scale + shift and ReLU (the spike's ``xla``
          baseline).
  gemm  — the im2col GEMM [3584, 576] × [576, N] with its operands resident
          in shared memory, repeated ``reps`` times inside the kernel
          (``ops.block1_kernel.gemm_probe``): N = 64 and the N = 128 control.
          The upper bound of any matmul-formulated conv kernel.
  fused — the fused conv+BN+ReLU kernel (``ops.block1_kernel.conv3x3_bn_relu``),
          checked at batch 2 against its plain version, then timed at --batch.

Each variant prints one JSON line: ``variant``, ``ms``, ``tflops`` (the
spike's FLOP counts) and the device. Times are CUDA events on the card.
``--device cpu`` runs the plain versions on the host clock, for the tests;
those times say nothing about the card.

``sass`` builds the kernels' library and prints, for each kernel function
in it, the count of the instructions that tell its design
(``cuobjdump -sass``): ``HGMMA`` (wgmma), ``HMMA`` (mma.sync), ``UTMALDG``
/ ``UTMASTG`` (TMA loads and stores), ``UBLKCP`` (bulk copies), ``LDSM``
(ldmatrix).

    python -m l3embedding_torch.tools.block1_spike [cudnn|gemm|fused|all|sass]
        [--batch 128] [--steps 20] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..compat.from_jax import block1_conv_from_jax
from ..ops import block1_kernel, cuda_build

B_DEF = 128
H = W = 224
C = 64
KH = KW = 3
TILE_H = 16  # output rows of the spike's im2col tile
M_TILE = TILE_H * W  # 3584 im2col rows
K_DIM = KH * KW * C  # 576


def timeit(fn, device: torch.device, steps: int = 20, warmup: int = 3) -> float:
    """Seconds per call of fn over `steps` calls after `warmup`: CUDA events
    on the card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        return (time.perf_counter() - t0) / steps
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(steps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / steps


def _inputs(batch, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, H, W, C).astype(np.float32) * 0.1
    w = rng.randn(KH, KW, C, C).astype(np.float32) * 0.05
    scale = rng.rand(C).astype(np.float32) + 0.5
    shift = rng.randn(C).astype(np.float32) * 0.1
    return x, w, scale, shift


def conv_operands(batch: int, device: torch.device):
    """The spike's seeded conv inputs on `device`: x (B, 224, 224, 64) bf16
    and block1_conv_from_jax's operands (w, w_oihw, scale, shift)."""
    x, w, scale, shift = _inputs(batch)
    ops = {k: v.to(device) for k, v in block1_conv_from_jax(w, scale, shift).items()}
    return torch.from_numpy(x).to(device).to(torch.bfloat16), ops


def gemm_operands(n_out: int, device: torch.device):
    """bench_gemm's seeded operands: a (3584, 576) and w (576, n_out) bf16
    (through f32), s and b (1, n_out) f32."""
    rng = np.random.RandomState(0)
    a = rng.randn(M_TILE, K_DIM) * 0.1
    w = rng.randn(K_DIM, n_out) * 0.05
    scale = rng.rand(1, n_out) + 0.5
    shift = rng.randn(1, n_out) * 0.1
    bf16 = [torch.from_numpy(v.astype(np.float32)).to(device).to(torch.bfloat16) for v in (a, w)]
    f32 = [torch.from_numpy(v.astype(np.float32)).to(device) for v in (scale, shift)]
    return (*bf16, *f32)


def cudnn_conv_bn_relu(x, w_oihw, scale, shift) -> torch.Tensor:
    """The library yardstick: cuDNN's bf16 conv on x (NHWC, i.e. channels-last
    NCHW) → f32 ·scale + shift → ReLU → bf16, NHWC out. Timed beside the
    kernel; the port never calls it."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w_oihw, padding=1).permute(0, 2, 3, 1)
    return torch.relu_(torch.addcmul(shift, y, scale)).to(torch.bfloat16)


def _result(variant: str, dt: float, flops: float, device: torch.device, **extra) -> dict:
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return {"variant": variant, "ms": dt * 1e3, "tflops": flops / dt / 1e12, "device": name, **extra}


def bench_cudnn(batch, steps, device=torch.device("cuda")):
    x, ops = conv_operands(batch, device)
    w_cl = ops["w_oihw"].contiguous(memory_format=torch.channels_last)
    with torch.backends.cudnn.flags(enabled=True, benchmark=True, allow_tf32=False):
        dt = timeit(lambda: cudnn_conv_bn_relu(x, w_cl, ops["scale"], ops["shift"]),
                    device, steps=steps)
    flops = 2 * batch * H * W * K_DIM * C
    return _result("cudnn_conv_bn_relu", dt, flops, device)


def bench_gemm(batch, steps, reps=64, n_out=C, device=torch.device("cuda")):
    """The GEMM probe's rate with its operands resident in shared memory
    (`batch` is unused, as in the spike)."""
    a, w, s, b = gemm_operands(n_out, device)
    dt = timeit(lambda: block1_kernel.gemm_probe(a, w, s, b, reps), device, steps=steps)
    flops = 2 * M_TILE * K_DIM * n_out * reps
    return _result(f"hopper_gemm_smem_n{n_out}", dt, flops, device, reps=reps)


def bench_fused(batch, steps, device=torch.device("cuda")):
    x, ops = conv_operands(batch, device)
    w, s, b = ops["w"], ops["scale"], ops["shift"]
    small = x[:2]
    got = block1_kernel.conv3x3_bn_relu(small, w, s, b).float()
    want = block1_kernel.conv3x3_bn_relu_ref(small, w, s, b).float()
    err = float((got - want).abs().max())
    rel = err / (float(want.abs().max()) + 1e-9)
    dt = timeit(lambda: block1_kernel.conv3x3_bn_relu(x, w, s, b), device, steps=steps)
    flops = 2 * batch * H * W * K_DIM * C
    return _result("hopper_fused_conv_bn_relu", dt, flops, device, max_abs_err=err, rel_err=rel)


SASS_OPCODES = ("HGMMA", "HMMA", "UTMALDG", "UTMASTG", "UBLKCP", "LDSM")
_KERNEL_NAME = re.compile(r"(block1_\w+?_kernel)(?:ILi(\d+)E)?")


def sass_opcodes(text: str) -> dict:
    """{kernel function: {opcode: count}} for the SASS_OPCODES in
    ``cuobjdump -sass`` text; a template's argument is kept in the name
    (``block1_gemm_kernel<64>``)."""
    out, name = {}, None
    for line in text.splitlines():
        if "Function : " in line:
            m = _KERNEL_NAME.search(line)
            name = (m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")) if m else line.split()[-1]
            out[name] = dict.fromkeys(SASS_OPCODES, 0)
        elif name is not None:
            for op in re.findall(r"\b(" + "|".join(SASS_OPCODES) + r")\b", line):
                out[name][op] += 1
    return out


def library_sass() -> dict:
    """sass_opcodes of the built block1_conv library (builds it first)."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    text = subprocess.run([tool, "-sass", str(cuda_build.build("block1_conv"))],
                          capture_output=True, text=True, check=True).stdout
    return sass_opcodes(text)


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("part", nargs="?", default="gemm", choices=["cudnn", "gemm", "fused", "all", "sass"])
    ap.add_argument("--batch", type=int, default=B_DEF)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("block1_spike: no CUDA device (--device cpu runs the plain versions)")

    results = []
    if args.part == "sass":
        results.append({"variant": "sass", "functions": library_sass()})
        print(json.dumps(results[-1]), flush=True)
    if args.part in ("cudnn", "all"):
        results.append(bench_cudnn(args.batch, args.steps, device))
        print(json.dumps(results[-1]), flush=True)
    if args.part in ("gemm", "all"):
        for n_out in (C, 128):
            results.append(bench_gemm(args.batch, args.steps, n_out=n_out, device=device))
            print(json.dumps(results[-1]), flush=True)
    if args.part in ("fused", "all"):
        results.append(bench_fused(args.batch, args.steps, device))
        print(json.dumps(results[-1]), flush=True)
    return results


if __name__ == "__main__":
    main()
