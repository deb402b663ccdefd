"""Train-mode BatchNorm as a hand-written Hopper kernel with its own
backward, and its plain version.

Replaces no TPU kernel: the JAX package leaves BatchNorm to XLA (flax's
``BatchNorm(use_running_average=False)``). It takes over the train-mode
BatchNorm that ``models/towers.py::_bn_f32`` writes out in tensor ops, whose
f32 elementwise kernels, casts and autograd backward moved ~230 bytes an
element and took ~80 % of a bf16 AVC train step on an H100. The function is
the same: flax's train mode, with the batch mean and the biased variance
E[x²] − E[x]² clipped at 0, ``y = (x − mean)·(rsqrt(var + eps)·γ) + β``
computed in f32 and rounded to the tower's dtype, and the running
statistics updated in place as ``ra = 0.99·ra + 0.01·batch``.

The CUDA source is ``l3embedding_torch/csrc/bn_train.cu``; ``cuda_build``
compiles it with ``nvcc`` for ``sm_90a`` at the first train-mode call (an
extraction never loads it) and loads it with ctypes. Bound by bytes: four
streaming passes over NCHW or channels-last NHWC (the towers' convs run
NHWC; y and dx keep x's layout), x read twice and y written forward, dy and x
read twice and dx written backward, ~16 bytes an element for bf16; only
(C,)-sized sums pass between the passes, combined in a fixed order, so
results repeat bit for bit. The source describes the design.

``bn_train`` is an autograd Function. Its passes take a CUDA tensor to the
kernel and a CPU tensor to the plain version below (``sums_ref``,
``normalise_ref``, ``grad_sums_ref``, ``grad_x_ref``: the same four passes in
tensor ops, the closed-form backward included); a CUDA tensor never falls
back. With a process group (sync BN, ``towers.sync_batch_norm``) the sums
after the first and the third pass, (2C + 1) and (2C) float64 values, are
all-reduced over the group, so that every rank normalises with the global
batch's statistics and forms dx from the global batch's gradient sums, as
the written-out sync BN does; dγ and dβ stay the rank's own.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter

import torch
import torch.distributed as dist

from . import cuda_build

# Launches of the CUDA kernel through bn_train, by the output dtype ("bf16",
# "f32"): one a forward (its sums, combine, finalize and normalise
# launches), and "<dtype>_backward" one a backward. LAUNCHES.clear() resets
# them.
LAUNCHES: Counter = Counter()

# The grid: a channel's N·H·W elements are cut into slices, one CTA each, so
# that about TARGET_CTAS CTAs run (several waves of the H100's 132 SMs) and a
# slice holds at least MIN_SLICE_VECTORS 16-byte vectors (a thread's few
# rounds of loads).
TARGET_CTAS = 2048
MIN_SLICE_VECTORS = 2048

_KINDS = {torch.bfloat16: "bf16", torch.float32: "f32"}


def slices(n: int, c: int, hw: int, element_bytes: int, nhwc: bool = False) -> int:
    """The CTAs a channel's n·hw elements are cut into (NCHW: a CTA takes
    one channel's slice), or the slices of the n·hw rows (NHWC: a CTA takes
    every channel of its rows)."""
    if nhwc:
        return max(1, min(TARGET_CTAS, n * hw * c * element_bytes // 16 // MIN_SLICE_VECTORS))
    vectors = n * hw * element_bytes // 16
    return max(1, min(-(-TARGET_CTAS // c), vectors // MIN_SLICE_VECTORS))


def channels_last(x: torch.Tensor) -> bool:
    """Whether the kernel takes x as NHWC: dense in channels-last order and
    not in NCHW order (a tensor that is both, such as one of one channel,
    has one memory order and goes as NCHW)."""
    return not x.is_contiguous() and x.is_contiguous(memory_format=torch.channels_last)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load("bn_train")
    p, i, f, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    layer = [i, q, i, q, i]  # channels_last, n, c, hw, slices (after the tensors and the dtype flags)
    for name, args in (("l3_bn_train_sums", [p, i, *layer, p, p, p]),
                       ("l3_bn_train_normalise", [p, p, i, i, *layer, p, p, p, p, p, f, f, f, p, p]),
                       ("l3_bn_train_grad_sums", [p, p, i, i, *layer, p, p, p, p]),
                       ("l3_bn_train_grad_x", [p, p, p, i, i, *layer, p, p, p, p, p, p, p, p, p])):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = i
    return lib


def _dense(x: torch.Tensor) -> bool:
    return x.is_contiguous() or x.is_contiguous(memory_format=torch.channels_last)


def _check(x: torch.Tensor, out_dtype: torch.dtype, *params: torch.Tensor) -> None:
    if x.dim() != 4 or x.dtype not in _KINDS or out_dtype not in _KINDS or not _dense(x) or x.numel() == 0:
        raise ValueError(
            "bn_train: need a non-empty bf16 or f32 NCHW tensor, dense in NCHW or NHWC order, and a bf16 or "
            f"f32 output, got {tuple(x.shape)} {x.dtype} strides {x.stride()} -> {out_dtype}")
    for t in params:
        if t.dtype != torch.float32 or t.shape != (x.shape[1],) or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"bn_train: need ({x.shape[1]},) f32 parameters and statistics on {x.device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


_DIMS, _SHAPE = (0, 2, 3), (1, -1, 1, 1)


def sums_ref(x):
    """Plain version of pass 1: (2C + 1) float64 — Σx, Σx², M. f32 values
    (x² rounded to f32) summed in float64, as the kernel combines its f32
    partial sums in double."""
    xf = x.float()
    m = x.numel() // x.shape[1]
    return torch.cat([xf.sum(_DIMS, dtype=torch.float64), (xf * xf).sum(_DIMS, dtype=torch.float64),
                      torch.full((1,), m, dtype=torch.float64, device=x.device)])


def normalise_ref(x, sums, weight, bias, running_mean, running_var, eps, keep, out_dtype):
    """Plain version of the forward's finalize and pass 2 from `sums` → (y,
    stats), stats (4, C) f32 (mean, mul, rstd, clipped); the moments rounded
    to f32 as the kernel rounds them; updates running_* in place."""
    c = x.shape[1]
    m = sums[2 * c]
    mean = (sums[:c] / m).float()
    raw = (sums[c:2 * c] / m).float() - mean * mean
    var = torch.clamp(raw, min=0.0)
    rstd = 1.0 / torch.sqrt(var + eps)
    mul = rstd * weight
    with torch.no_grad():
        running_mean.mul_(keep).add_(mean, alpha=1 - keep)
        running_var.mul_(keep).add_(var, alpha=1 - keep)
    y = ((x.float() - mean.view(_SHAPE)) * mul.view(_SHAPE) + bias.view(_SHAPE)).to(out_dtype)
    return y, torch.stack([mean, mul, rstd, (raw < 0).float()])


def grad_sums_ref(dy, x, stats):
    """Plain version of pass 3: (2C) float64 — Σdy, Σdy·(x − mean), f32
    products summed in float64."""
    g = dy.float()
    xc = x.float() - stats[0].view(_SHAPE)
    return torch.cat([g.sum(_DIMS, dtype=torch.float64), (g * xc).sum(_DIMS, dtype=torch.float64)])


def grad_x_ref(dy, x, weight, stats, local, glob, count, need_dx: bool):
    """Plain version of the backward's finalize and pass 4 → (dx or None,
    dweight, dbias): dweight, dbias from `local`, dx's coefficients from
    `glob` and `count` (M, a (1,) float64), formed in float64 — the closed
    form of the written-out graph's gradient."""
    c = x.shape[1]
    mean, mul, rstd, clipped = stats
    r = rstd.double()
    dweight, dbias = (r * local[c:]).float(), local[:c].float()
    if not need_dx:
        return None, dweight, dbias
    sg, sgx = glob[:c], glob[c:]
    k = torch.where(clipped != 0, torch.zeros_like(sgx), weight.double() * r ** 3 * sgx / count).float()
    g = dy.float()
    xc = x.float() - mean.view(_SHAPE)
    dx = mul.view(_SHAPE) * (g - (sg / count).float().view(_SHAPE)) - k.view(_SHAPE) * xc
    return dx.to(x.dtype), dweight, dbias


def forward_ref(x, weight, bias, running_mean, running_var, eps, keep, out_dtype):
    """Plain version of the forward passes on this batch alone → (y,
    stats)."""
    return normalise_ref(x, sums_ref(x), weight, bias, running_mean, running_var, eps, keep, out_dtype)


def backward_ref(dy, x, weight, stats, need_dx: bool):
    """Plain version of the backward passes on this batch alone → (dx or
    None, dweight, dbias)."""
    local = grad_sums_ref(dy, x, stats)
    count = torch.full((1,), x.numel() // x.shape[1], dtype=torch.float64, device=x.device)
    return grad_x_ref(dy, x, weight, stats, local, local, count, need_dx)


def _layer(x: torch.Tensor) -> tuple:
    """(channels_last, n, c, hw, slices) of x's passes."""
    n, c, h, w = x.shape
    nhwc = channels_last(x)
    return int(nhwc), n, c, h * w, slices(n, c, h * w, x.element_size(), nhwc)


def _call(x: torch.Tensor, entry: str, *args) -> None:
    with cuda_build.on_device(x.device):
        rc = getattr(_library(), entry)(*args, _stream(x))
    if rc != 0:
        raise RuntimeError(f"train-mode BatchNorm kernel {entry} failed: CUDA error {rc}")


def _bf16(t: torch.Tensor) -> int:
    return int(t.dtype == torch.bfloat16)


def _forward(x, weight, bias, running_mean, running_var, eps, keep, out_dtype, group=None):
    """→ (y, stats, sums): the forward passes, the sums all-reduced over
    `group` between the first two."""
    layer = _layer(x)
    if x.device.type == "cpu":
        sums = sums_ref(x)
    else:
        c, s = layer[2], layer[4]
        sums = torch.empty(2 * c + 1, device=x.device, dtype=torch.float64)
        partials = torch.empty((2, c, s), device=x.device, dtype=torch.float32)
        _call(x, "l3_bn_train_sums", x.data_ptr(), _bf16(x), *layer, partials.data_ptr(), sums.data_ptr())
    if group is not None:
        dist.all_reduce(sums, group=group)
    if x.device.type == "cpu":
        y, stats = normalise_ref(x, sums, weight, bias, running_mean, running_var, eps, keep, out_dtype)
        return y, stats, sums
    y = torch.empty_like(x, dtype=out_dtype)  # x's layout
    stats = torch.empty((4, layer[2]), device=x.device, dtype=torch.float32)
    _call(x, "l3_bn_train_normalise", x.data_ptr(), y.data_ptr(), _bf16(x), int(out_dtype == torch.bfloat16),
          *layer, sums.data_ptr(), weight.data_ptr(), bias.data_ptr(), running_mean.data_ptr(),
          running_var.data_ptr(), eps, keep, 1 - keep, stats.data_ptr())
    LAUNCHES[_KINDS[out_dtype]] += 1
    return y, stats, sums


def _backward(dy, x, weight, stats, sums, need_dx: bool, group=None):
    """→ (dx or None, dweight, dbias): the backward passes, the gradient's
    sums all-reduced over `group` between them; `sums` is the forward's,
    whose last element is M."""
    layer = _layer(x)
    c = layer[2]
    count = sums[2 * c:]
    if x.device.type == "cpu":
        local = grad_sums_ref(dy, x, stats)
    else:
        dy = dy.contiguous(memory_format=torch.channels_last if layer[0] else torch.contiguous_format)
        local = torch.empty(2 * c, device=x.device, dtype=torch.float64)
        partials = torch.empty((2, c, layer[4]), device=x.device, dtype=torch.float32)
        _call(x, "l3_bn_train_grad_sums", dy.data_ptr(), x.data_ptr(), _bf16(x), _bf16(dy), *layer,
              stats.data_ptr(), partials.data_ptr(), local.data_ptr())
    glob = local
    if group is not None and need_dx:  # dγ and dβ take the local sums alone
        glob = local.clone()
        dist.all_reduce(glob, group=group)
    if x.device.type == "cpu":
        return grad_x_ref(dy, x, weight, stats, local, glob, count, need_dx)
    dx = torch.empty_like(x) if need_dx else None
    dweight, dbias = (torch.empty(c, device=x.device, dtype=torch.float32) for _ in range(2))
    coef = torch.empty((2, c), device=x.device, dtype=torch.float32)
    _call(x, "l3_bn_train_grad_x", dy.data_ptr(), x.data_ptr(), dx.data_ptr() if need_dx else None, _bf16(x),
          _bf16(dy), *layer, local.data_ptr(), glob.data_ptr(), count.data_ptr(), weight.data_ptr(),
          stats.data_ptr(), dweight.data_ptr(), dbias.data_ptr(), coef.data_ptr())
    LAUNCHES[f"{_KINDS[dy.dtype]}_backward"] += 1
    return dx, dweight, dbias


class _BNTrain(torch.autograd.Function):
    """y = bn_train(x); saves x in its own dtype, the (4, C) statistics and
    the (2C + 1) sums."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, eps, keep, out_dtype, group):
        y, stats, sums = _forward(x, weight, bias, running_mean, running_var, eps, keep, out_dtype, group)
        ctx.save_for_backward(x, weight, stats, sums)
        ctx.group = group
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, stats, sums = ctx.saved_tensors
        dx, dweight, dbias = _backward(dy, x, weight, stats, sums, ctx.needs_input_grad[0], ctx.group)
        return dx, dweight, dbias, None, None, None, None, None, None


def bn_train(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, running_mean: torch.Tensor,
             running_var: torch.Tensor, eps: float, momentum: float, out_dtype: torch.dtype,
             group=None) -> torch.Tensor:
    """Train-mode BatchNorm of (N, C, H, W) x (bf16 or f32) → y in
    `out_dtype` (bf16 or f32) and in x's layout, computed in f32 with the
    batch's statistics; running_mean and running_var (f32) become
    ``momentum·r + (1 − momentum)·batch`` in place. weight and bias are f32
    and take gradients, as x does where it requires one. x dense in NCHW or
    in channels-last order is taken as it is, any other x made contiguous
    first. With a process group of several ranks (sync BN) the batch is the
    global one: the statistics are every rank's rows', and so is dx's
    share of the loss through them; every rank of the group has to call."""
    if not _dense(x):
        x = x.contiguous()
    _check(x, out_dtype, weight, bias, running_mean, running_var)
    return _BNTrain.apply(x, weight, bias, running_mean, running_var, float(eps), float(momentum), out_dtype, group)
