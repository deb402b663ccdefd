"""Time the int8 conv kernel of two checkouts of this repo on one card, in the
order A, B, B, A, each run in a process of its own (or of one checkout, run
once).

    python -m l3embedding_torch.tools.int8_ab DIR_A [DIR_B] [--steps 20]
    python -m l3embedding_torch.tools.int8_ab --sass   # this checkout's SASS

Each run imports the ``l3embedding_torch`` of its checkout, builds its
``int8_conv`` source there and times, at every conv shape of the
cnn_L3_melspec2 int8 tower at 64 windows (``SHAPES``, on ``chip_smoke.py``'s
seeded inputs), per call between CUDA events (3 warm-up calls, ``steps``
timed):

  * ``conv3x3_s8`` as the tower calls it: after blocks 1, 3 and 5 the
    pooled call where the checkout's wrapper takes ``pool``, else the conv
    followed by the plain 2×2 pool (``pooled``), and the conv alone
    (``kernel``);
  * the library call of the same function: im2col + ``torch._int_mm`` + the
    epilogue in torch ops (+ the pool where pooled), ``library_int8_conv``.

Every time carries the card's SM clock, power draw and temperature as
nvidia-smi reads them just after it, and each shape its bound
(``int8_conv_bound``: operations at 1979 TOP/s int8 or bytes at 3.35 TB/s,
the larger; a pooled call writes a quarter of the bytes). Prints one JSON
line per run. ``--sass`` prints instead the counts of IGMMA (wgmma on
integers), IMMA (mma.sync), UTMALDG (TMA loads) and IDP (``__dp4a``) in each
kernel function of this checkout's built library (``cuobjdump -sass``).
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import re
import shutil
import subprocess
import sys

PEAK_INT8_TC, PEAK_HBM = 1979e12, 3.35e12
BATCH = 64
# (H, W, Cin, Cout, requant epilogue, pooled after it): blocks 0-6 of the
# cnn_L3_melspec2 int8 tower at 64 windows, then the embedding conv.
SHAPES = ((256, 199, 1, 64, True, False), (256, 199, 64, 64, True, True), (128, 99, 64, 128, True, False),
          (128, 99, 128, 128, True, True), (64, 49, 128, 256, True, False), (64, 49, 256, 256, True, True),
          (32, 24, 256, 512, True, False), (32, 24, 512, 512, False, False))


def int8_conv_bound(batch, h, w, cin, cout, requant, pool=False) -> tuple[float, float]:
    """(ops seconds, bytes seconds) of one int8 conv: 2·pixels·9·Cin·Cout
    operations at the dense int8 tensor-core peak; x, the weights, deq and
    bias read once and the output written once (a quarter of it, floor,
    when pooled) at the HBM rate."""
    npix = batch * h * w
    out_pix = batch * (h // 2) * (w // 2) if pool else npix
    ops = 2.0 * npix * 9 * cin * cout
    bytes_ = npix * cin + 9 * cin * cout + 2 * cout * 4 + out_pix * cout * (1 if requant else 4)
    return ops / PEAK_INT8_TC, bytes_ / PEAK_HBM


def library_int8_conv(x, w_packed, deq, bias, s_next, pool=False):
    """im2col (nine shifted views of the zero-padded NHWC input, K padded as
    the packed weights are) + torch._int_mm + the epilogue in torch ops (+
    the 2×2 pool): the int8 conv's yardstick, timed only here and in
    chip_smoke.py; the port never calls it."""
    import torch

    from l3embedding_torch.ops import int8_conv_kernel as ick

    batch, h, w, cin = x.shape
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    cols = torch.stack([xp[:, dy:dy + h, dx:dx + w, :] for dy in range(3) for dx in range(3)], dim=3)
    cols = cols.reshape(batch * h * w, 9 * cin)
    if cols.shape[1] != w_packed.shape[1]:
        cols = torch.nn.functional.pad(cols, (0, w_packed.shape[1] - cols.shape[1]))
    acc = torch._int_mm(cols, w_packed.t()).reshape(batch, h, w, -1)
    if s_next is None:
        return ick.dequant_epilogue(acc, deq, bias)
    q = ick.requant_epilogue(acc, deq, bias, s_next)
    if not pool:
        return q
    q = q[:, : h // 2 * 2, : w // 2 * 2]
    return q.reshape(batch, h // 2, 2, w // 2, 2, -1).amax(dim=(2, 4))


def operands(h, w, cin, cout, requant, dev, gen):
    """chip_smoke.py's seeded operands of one shape: ReLU'd int8 input past
    the first conv, uniform int8 weights, deq scaled to the accumulator's
    spread, bias, s_next."""
    import torch

    from l3embedding_torch.ops import int8_conv_kernel as ick

    x = torch.randint(-127, 128, (BATCH, h, w, cin), device=dev, generator=gen, dtype=torch.int8)
    if cin > 1:
        x = x.clamp_(min=0)  # the tower's inputs past the first conv are ReLU'd
    wq = torch.randint(-127, 128, (3, 3, cin, cout), generator=torch.Generator().manual_seed(cin + cout),
                       dtype=torch.int8)
    w_packed = ick.pack_weights(wq.numpy()).to(dev)
    acc_std = (9 * cin) ** 0.5 * 127 * 127 / 3
    deq = (torch.rand(cout, device=dev, generator=gen) + 0.5) / acc_std
    bias = torch.randn(cout, device=dev, generator=gen) * 0.1
    s_next = torch.tensor([2.5 / 127], device=dev) if requant else None
    return x, w_packed, deq, bias, s_next


SASS_OPCODES = ("IGMMA", "IMMA", "UTMALDG", "IDP")
_KERNEL_NAME = re.compile(r"(int8_conv3x3_[a-z0-9]+_kernel)(?:IL[ib](\d+)E)?")


def library_sass() -> dict:
    """{kernel function: {opcode: count}} of SASS_OPCODES in the built
    int8_conv library (built first); a template's argument is kept in the
    name (``int8_conv3x3_wgmma_kernel<1>``)."""
    from l3embedding_torch.ops import cuda_build

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    text = subprocess.run([tool, "-sass", str(cuda_build.build("int8_conv"))],
                          capture_output=True, text=True, check=True).stdout
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


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def _child(steps: int) -> dict:
    import torch

    from l3embedding_torch.ops import cuda_build
    from l3embedding_torch.ops import int8_conv_kernel as ick

    cuda_build.build("int8_conv")
    fused_pool = "pool" in inspect.signature(ick.conv3x3_s8).parameters

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

    def pooled(x, w, d, b, s):
        if fused_pool:
            return ick.conv3x3_s8(x, w, d, b, s, pool=True)
        q = ick.conv3x3_s8(x, w, d, b, s)
        h, wd = q.shape[1] // 2 * 2, q.shape[2] // 2 * 2
        return q[:, :h, :wd].reshape(q.shape[0], h // 2, 2, wd // 2, 2, -1).amax(dim=(2, 4))

    gen = torch.Generator(device="cuda").manual_seed(9)
    out = {"fused_pool": fused_pool, "shapes": []}
    for h, w, cin, cout, requant, pool in SHAPES:
        args = operands(h, w, cin, cout, requant, "cuda", gen)
        ops_s, bytes_s = int8_conv_bound(BATCH, h, w, cin, cout, requant)
        row = {"shape": [BATCH, h, w, cin, cout], "requant": requant,
               "kernel": events_ms(lambda: ick.conv3x3_s8(*args)),
               "library": events_ms(lambda: library_int8_conv(*args), iters=5, warmup=1),
               "bound_ms": max(ops_s, bytes_s) * 1e3, "bound_by": "operations" if ops_s > bytes_s else "bytes"}
        if pool:
            ops_p, bytes_p = int8_conv_bound(BATCH, h, w, cin, cout, requant, pool=True)
            row["pooled"] = events_ms(lambda: pooled(*args))
            row["pooled_library"] = events_ms(lambda: library_int8_conv(*args, pool=True), iters=5, warmup=1)
            row["pooled_bound_ms"] = max(ops_p, bytes_p) * 1e3
        out["shapes"].append(row)
        del args
        torch.cuda.empty_cache()
    # The tower as it runs: the pooled call where the tower pools.
    out["tower_ms"] = sum(r["pooled"]["ms"] if "pooled" in r else r["kernel"]["ms"] for r in out["shapes"])
    out["tower_bound_ms"] = sum(r.get("pooled_bound_ms", r["bound_ms"]) for r in out["shapes"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", help="one checkout of the repo, or two: A B")
    ap.add_argument("--steps", type=int, default=20, help="timed calls per measurement (default 20)")
    ap.add_argument("--sass", action="store_true", help="print this checkout's SASS opcode counts")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.sass:
        print(json.dumps(library_sass()), flush=True)
        return 0
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
