"""One rank of a two-rank check of train-mode BatchNorm under sync BN.

``ops/bn_kernel.py::bn_train`` with the group (on a card the kernel, on the
CPU its plain version) against the written-out ``towers._bn_f32`` in
float64 inside ``towers.sync_batch_norm`` (``_batch_moments``), each on this
rank's rows of one seeded global batch: y, dx, dγ, dβ and the running
statistics as relative errors, and how far the rank's own statistics alone
(``bn_train`` without the group) would have put y. Rank 0 takes more rows
than rank 1, and the rows drift, so that the ranks' batches differ.

    python tests/torch_port_bn_sync_worker.py RANK PORT BACKEND DEVICE OUT_JSON

DEVICE is ``cpu``, ``cuda`` (both ranks on the first card) or ``cuda:rank``
(a card a rank). Writes {case: {"errs": {...}, "local_y_err": ...,
"launches": {...}}} to OUT_JSON.
"""

import json
import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from l3embedding_torch.models import towers  # noqa: E402
from l3embedding_torch.ops import bn_kernel  # noqa: E402

EPS = 1e-3
CASES = {
    # name: (global shape, rank 0's rows, in dtype, out dtype, x takes a gradient, channels-last)
    "f32": ((6, 8, 40, 30), 4, torch.float32, torch.float32, True, False),
    "bf16_nhwc": ((6, 64, 64, 50), 4, torch.bfloat16, torch.bfloat16, True, True),
    "input": ((6, 1, 256, 199), 4, torch.float32, torch.bfloat16, False, True),  # the audio input BN
}
# Relative error bounds against float64: y and dx one rounding to bf16
# (2^-9 an element) with room, else the f32 bound of the plain version's
# one-process test (3e-5); the running statistics 1e-6.
LIMITS = {"y": {torch.bfloat16: 2 ** -8, torch.float32: 3e-5}, "dx": {torch.bfloat16: 2 ** -8, torch.float32: 3e-5},
          "dscale": 3e-5, "dbias": 3e-5, "running_mean": 1e-6, "running_var": 1e-6}


def layer(c, dtype, device):
    g = torch.Generator().manual_seed(c)
    bn = torch.nn.BatchNorm2d(c, eps=EPS)
    with torch.no_grad():
        bn.weight.copy_(1 + 0.1 * torch.randn(c, generator=g))
        bn.bias.copy_(0.05 * torch.randn(c, generator=g))
        bn.running_mean.copy_(torch.randn(c, generator=g))
        bn.running_var.copy_(1 + torch.rand(c, generator=g))
    return bn.to(dtype).to(device)


def inputs(case, rank, device):
    """This rank's rows of x (in its dtype and layout) and of dy (the output
    dtype's values), from the seeded global batch."""
    shape, rows0, in_dtype, out_dtype, _, nhwc = CASES[case]
    g = torch.Generator().manual_seed(5)
    n = shape[0]
    drift = 0.3 * torch.arange(n, dtype=torch.float32).view(n, 1, 1, 1)
    x = torch.randn(*shape, generator=g) * 1.7 + 0.4 + drift
    dy = 1e-3 * (torch.randn(*shape, generator=g) + x)  # correlated with x: Σdy·(x − mean) does not cancel
    rows = slice(0, rows0) if rank == 0 else slice(rows0, n)
    fmt = torch.channels_last if nhwc else torch.contiguous_format
    x = x[rows].to(device=device, dtype=in_dtype).contiguous(memory_format=fmt)
    dy = dy[rows].to(device=device, dtype=out_dtype).contiguous(memory_format=fmt)
    return x, dy


def rel(a, b):
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).norm() / b.norm())


def run_case(case, rank, device, group):
    _, _, _, out_dtype, grad, _ = CASES[case]
    x, dy = inputs(case, rank, device)
    c = x.shape[1]
    bn_kernel.LAUNCHES.clear()
    bn = layer(c, torch.float32, device)
    xg = x.detach().requires_grad_(grad)
    y = bn_kernel.bn_train(xg, bn.weight, bn.bias, bn.running_mean, bn.running_var, EPS, towers.BN_MOMENTUM,
                           out_dtype, group=group)
    y.backward(dy)
    ref_bn = layer(c, torch.float64, device)
    x64 = x.double().requires_grad_(grad)
    with towers.sync_batch_norm(group):
        y64, _ = towers._bn_f32(ref_bn, x64, True)
    (y64 * dy.double()).sum().backward()
    got = {"y": y, "dscale": bn.weight.grad, "dbias": bn.bias.grad, "running_mean": bn.running_mean,
           "running_var": bn.running_var}
    want = {"y": y64, "dscale": ref_bn.weight.grad, "dbias": ref_bn.bias.grad,
            "running_mean": ref_bn.running_mean, "running_var": ref_bn.running_var}
    if grad:
        got["dx"], want["dx"] = xg.grad, x64.grad
    errs = {k: rel(got[k], want[k]) for k in got}
    alone = layer(c, torch.float32, device)
    with torch.no_grad():
        y_alone = bn_kernel.bn_train(x, alone.weight, alone.bias, alone.running_mean, alone.running_var, EPS,
                                     towers.BN_MOMENTUM, out_dtype)
    if device != "cpu":
        torch.cuda.synchronize()
    return {"errs": errs, "local_y_err": rel(y_alone, y64), "launches": dict(bn_kernel.LAUNCHES),
            "grad_is_none": xg.grad is None}


def main(rank, port, backend, device, out):
    torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank)
    if device == "cuda:rank":
        device = f"cuda:{rank}"
        torch.cuda.set_device(rank)
    results = {case: run_case(case, rank, device, dist.group.WORLD) for case in CASES}
    dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(results, f)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
