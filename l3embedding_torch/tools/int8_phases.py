"""Where the int8 conv's `wgmma` kernel spends its time, on the card: clock64
phase times of its consumer warpgroups at the cnn_L3_melspec2 tower's
shapes (int8_ab.SHAPES, Cin a multiple of 64).

    python -m l3embedding_torch.tools.int8_phases [--steps 20]

Builds an instrumented copy of ``csrc/int8_conv.cu`` (timers patched in
around the consumer's phases; the kernel's code is otherwise the same) into
``build/int8_phases/`` with nvcc, runs each shape, checks the output against
the plain version, and prints one JSON line a call: ms (CUDA events), and
per item of a consumer warpgroup the cycles spent waiting for a stage,
in the math (wgmma, from the stage's arrival to the last wait), in the
epilogue, and the epilogue's parts (staging the accumulators, its loop).
The patch anchors on the kernel's source text and fails loudly when the
source moves on.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess

COUNTERS = ("wait", "math", "epilogue", "total", "staging", "loop")

# (anchor, replacement): timers around the consumer's phases.
PATCHES = (
    ("namespace {\n", "__device__ unsigned long long g_phases[132 * 2 * 6];\nnamespace {\n"),
    ("  for (int li = wg; li < n_local; li += 2) {\n    const int pair = li >> 1",
     "  unsigned long long t[6] = {0, 0, 0, 0, 0, 0};\n  const unsigned long long t_all = clock64();\n"
     "  for (int li = wg; li < n_local; li += 2) {\n    const int pair = li >> 1"),
    ("      mbar_wait(full + 8 * st, (seq / p.stages) & 1);\n      const uint32_t base",
     "      const unsigned long long tw0 = clock64();\n      mbar_wait(full + 8 * st, (seq / p.stages) & 1);\n"
     "      const unsigned long long tw1 = clock64();\n      t[0] += tw1 - tw0;\n      const uint32_t base"),
    ("      fence_acc(acc);\n      // The stage is read;",
     "      fence_acc(acc);\n      t[1] += clock64() - tw1;\n      // The stage is read;"),
    ("    int* acc_s = reinterpret_cast<int*>(stages + st * p.stage_bytes);",
     "    const unsigned long long te0 = clock64();\n    int* acc_s = reinterpret_cast<int*>(stages + st * p.stage_bytes);"),
    ("    bar_sync(1 + wg, 128);  // the tile's accumulators are staged\n",
     "    bar_sync(1 + wg, 128);  // the tile's accumulators are staged\n"
     "    const unsigned long long tb1 = clock64();\n    t[4] += tb1 - te0;\n"),
    ("    // The staging reads (generic proxy) before the stage's next TMA write.\n",
     "    t[5] += clock64() - tb1;\n    // The staging reads (generic proxy) before the stage's next TMA write.\n"),
    ("    if (wtid == 0) mbar_arrive(empty + 8 * st);\n  }\n}\n",
     "    if (wtid == 0) mbar_arrive(empty + 8 * st);\n    t[2] += clock64() - te0;\n  }\n"
     "  t[3] = clock64() - t_all;\n"
     "  if (wtid == 0)\n    for (int k = 0; k < 6; ++k) g_phases[(blockIdx.x * 2 + wg) * 6 + k] = t[k];\n}\n"),
)


def instrumented_source(src: str) -> str:
    for anchor, replacement in PATCHES:
        if src.count(anchor) != 1:
            raise SystemExit(f"int8_phases: the kernel source no longer has {anchor[:50]!r} once")
        src = src.replace(anchor, replacement)
    return src + ('\nextern "C" int l3_int8_phases(void* host) {\n'
                  '  return (int)cudaMemcpyFromSymbol(host, g_phases, sizeof(g_phases));\n}\n')


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=20, help="timed calls per shape (default 20)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from l3embedding_torch.ops import cuda_build
    from l3embedding_torch.ops import int8_conv_kernel as ick
    from l3embedding_torch.tools import int8_ab

    if not torch.cuda.is_available():
        raise SystemExit("int8_phases: no CUDA device")
    out_dir = cuda_build.BUILD_DIR.parent / "int8_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / "int8_conv_phases.cu", out_dir / "libint8_conv_phases.so"
    cu.write_text(instrumented_source((cuda_build.CSRC / "int8_conv.cu").read_text()))
    subprocess.run([cuda_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-I", str(cuda_build.CSRC), "-o", str(so), str(cu)],
                   check=True)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.l3_int8_conv3x3.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, p]
    lib.l3_int8_conv3x3.restype = i
    lib.l3_int8_phases.argtypes = [p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if sms > 132:
        raise SystemExit(f"int8_phases: counters sized for 132 SMs, the card has {sms}")

    gen = torch.Generator(device="cuda").manual_seed(9)
    for h, w, cin, cout, requant, pooled in int8_ab.SHAPES:
        if cin % ick.K_STEP:
            continue
        args_ = int8_ab.operands(h, w, cin, cout, requant, "cuda", gen)
        x, wp, deq, bias, s_next = args_
        for pool in (False, True) if pooled else (False,):
            batch = x.shape[0]
            out = torch.empty((batch, h // 2, w // 2, cout) if pool else (batch, h, w, cout), device="cuda",
                              dtype=torch.int8 if requant else torch.float32)
            th, tw = ick.tile_plan(h, w, pool)

            def call():
                rc = lib.l3_int8_conv3x3(x.data_ptr(), wp.data_ptr(), deq.data_ptr(), bias.data_ptr(),
                                         None if s_next is None else s_next.data_ptr(), out.data_ptr(), batch, h,
                                         w, cin, cout, wp.shape[1], int(pool), th, tw,
                                         torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise SystemExit(f"int8_phases: launch failed, CUDA error {rc}")

            for _ in range(3):
                call()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(args.steps):
                call()
            end.record()
            torch.cuda.synchronize()
            equal = torch.equal(out, ick.conv3x3_s8_ref(*args_, pool=pool))
            counts = np.zeros(132 * 2 * 6, np.uint64)
            if lib.l3_int8_phases(counts.ctypes.data):
                raise SystemExit("int8_phases: reading the counters failed")
            n_items = batch * -(-h // th) * -(-w // tw) * (cout // 64)
            per_item = counts.reshape(132, 2, 6)[:sms].astype(np.float64).sum(axis=(0, 1)) / n_items
            print(json.dumps({"shape": [batch, h, w, cin, cout], "pool": pool, "requant": requant,
                              "ms": start.elapsed_time(end) / args.steps, "equal": equal,
                              "cycles_per_item": {k: round(float(v), 1) for k, v in zip(COUNTERS, per_item)}}),
                  flush=True)
        del args_
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
