"""The int8 tower's 3×3 convolution as a hand-written Hopper kernel, with its
plain version.

Computes ``l3embedding_tpu/embed/quantized.py::_conv(q, w, jnp.int32)`` (an
NHWC/HWIO 3×3 SAME conv, stride 1, zero padding, exact under symmetric
quantization) and, per output channel c, one of the int8 tower's epilogues:

  * requant (``s_next`` given; blocks 0-6): ``y = max(f32(acc)·deq[c] + b[c],
    0)``, then ``clip(round_half_even(y / s_next), −127, 127)`` as int8;
    with ``pool=True`` followed by the 2×2 VALID max-pool of blocks 1, 3
    and 5 (JAX's ``reduce_window`` after the requantize);
  * dequant (``s_next`` None; the embedding conv): ``f32(acc)·deq[c] + b[c]``.

The CUDA source is ``l3embedding_torch/csrc/int8_conv.cu``: for Cin a
multiple of 64, ``wgmma`` on s8 operands fed by TMA, the epilogue and the
pool in the same kernel, tiles from ``tile_plan``; other Cin a general
``mma.sync`` kernel and Cin 1 a ``__dp4a`` one, neither of which pools.
``cuda_build`` compiles it with ``nvcc`` for ``sm_90a`` at first use. The
weights go to the kernel packed (``pack_weights``): row c holds output
channel c's taps in (dy, dx, ci) order, zero-padded from 9·Cin to a multiple
of K_STEP. ``conv3x3_s8`` takes a CUDA tensor to the kernel and a CPU tensor
to ``conv3x3_s8_ref``; a CUDA tensor never falls back: a build or launch
failure raises.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter

import numpy as np
import torch
import torch.nn.functional as F

from . import cuda_build

K_STEP = 64  # bytes of K a stage of the kernel (csrc/int8_conv.cu BK)
N_STEP = 64  # output channels a block: Cout must be a multiple
WIDE = 208  # pixels a wgmma accumulator covers (csrc/int8_conv.cu WIDE)

# Launches of the CUDA kernel through conv3x3_s8, under "s8": one per call on
# a CUDA tensor. LAUNCHES.clear() resets them.
LAUNCHES: Counter = Counter()


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load("int8_conv")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.l3_int8_conv3x3.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, p]
    lib.l3_int8_conv3x3.restype = i
    lib.l3_int8_conv_k_step.restype = i
    lib.l3_int8_conv_wide.restype = i
    if (lib.l3_int8_conv_k_step(), lib.l3_int8_conv_wide()) != (K_STEP, WIDE):
        raise RuntimeError(f"int8_conv.cu takes K in slices of {lib.l3_int8_conv_k_step()} and "
                           f"{lib.l3_int8_conv_wide()} wide pixels; the wrapper plans {K_STEP}, {WIDE}")
    return lib


def tile_plan(h: int, w: int, pool: bool) -> tuple[int, int]:
    """(TH, TW) of the wgmma kernel's output tile: TH rows × TW columns whose
    "wide" pixels — rows of TW + 2, the slab's width — fit one accumulator:
    (TH − 1)·(TW + 2) + TW ≤ WIDE. TW is W where W ≤ WIDE − 2, and TH as
    many rows as fit. Pooled, TH is even and a tile narrower than the image
    has an even TW, so that every 2×2 quad lies in one tile."""
    tw = min(w, WIDE - 2)
    th = (WIDE - tw) // (tw + 2) + 1
    if pool:
        th -= th % 2
        if th == 0:  # two rows of an even width
            tw, th = (WIDE - 2) // 4 * 2, 2
    return th, tw


def padded_k(cin: int) -> int:
    return -(-9 * cin // K_STEP) * K_STEP


def pack_weights(w_hwio) -> torch.Tensor:
    """(3, 3, Cin, Cout) int8 HWIO weights → (Cout, padded_k(Cin)) int8, row c
    the taps of output channel c in (dy, dx, ci) order, then zeros."""
    w = torch.as_tensor(np.asarray(w_hwio))
    if w.dim() != 4 or w.shape[:2] != (3, 3) or w.dtype != torch.int8:
        raise ValueError(f"pack_weights: need (3, 3, Cin, Cout) int8, got {tuple(w.shape)} {w.dtype}")
    cin, cout = w.shape[2], w.shape[3]
    packed = torch.zeros((cout, padded_k(cin)), dtype=torch.int8)
    packed[:, : 9 * cin] = w.reshape(9 * cin, cout).t()
    return packed


def _check(x, w_packed, deq, bias, s_next, pool=False):
    if x.dim() != 4 or x.dtype != torch.int8:
        raise ValueError(f"conv3x3_s8: need x (B, H, W, Cin) int8, got {tuple(x.shape)} {x.dtype}")
    cin = x.shape[-1]
    cout = w_packed.shape[0]
    if w_packed.dtype != torch.int8 or tuple(w_packed.shape) != (cout, padded_k(cin)):
        raise ValueError(f"conv3x3_s8: need packed weights (Cout, {padded_k(cin)}) int8 for Cin "
                         f"{cin}, got {tuple(w_packed.shape)} {w_packed.dtype}")
    if cout % N_STEP:
        raise ValueError(f"conv3x3_s8: Cout must be a multiple of {N_STEP}, got {cout}")
    for name, v in (("deq", deq), ("bias", bias)):
        if v.dtype != torch.float32 or tuple(v.shape) != (cout,):
            raise ValueError(f"conv3x3_s8: need {name} ({cout},) float32, got {tuple(v.shape)} {v.dtype}")
    if s_next is not None and (s_next.dtype != torch.float32 or s_next.numel() != 1):
        raise ValueError(f"conv3x3_s8: need s_next one float32, got {tuple(s_next.shape)} {s_next.dtype}")
    if pool and s_next is None:
        raise ValueError("conv3x3_s8: pool follows the requant epilogue: give s_next")
    tensors = [x, w_packed, deq, bias] + ([] if s_next is None else [s_next])
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"conv3x3_s8: inputs on several devices {sorted(map(str, devices))}")
    return tensors


def conv3x3_s32_ref(x: torch.Tensor, w_packed: torch.Tensor) -> torch.Tensor:
    """The exact int32 conv: (B, H, W, Cin) int8 → (B, H, W, Cout) int32,
    computed in float64, where every partial sum is an exact integer
    (|sum| ≤ 9·Cin·127² < 2⁵³)."""
    cin, cout = x.shape[-1], w_packed.shape[0]
    w_oihw = w_packed[:, : 9 * cin].reshape(cout, 3, 3, cin).permute(0, 3, 1, 2).double()
    y = F.conv2d(x.permute(0, 3, 1, 2).double(), w_oihw, padding=1)
    return y.permute(0, 2, 3, 1).to(torch.int32).contiguous()


def dequant_epilogue(acc: torch.Tensor, deq: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """f32(acc)·deq + bias, a multiply then an add (two roundings)."""
    return acc.float() * deq + bias


def requant_epilogue(acc, deq, bias, s_next) -> torch.Tensor:
    """clip(round_half_even(max(f32(acc)·deq + bias, 0) / s_next), ±127) → int8."""
    y = torch.clamp(dequant_epilogue(acc, deq, bias), min=0.0)
    return torch.clamp(torch.round(y / s_next.reshape(())), -127, 127).to(torch.int8)


def pool2_int8(q: torch.Tensor) -> torch.Tensor:
    """2×2 VALID max-pool of an NHWC int8 tensor (a reshape and amax; an odd
    last row or column is dropped)."""
    b, h, w, c = q.shape
    q = q[:, : h // 2 * 2, : w // 2 * 2]
    return q.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def conv3x3_s8_ref(x, w_packed, deq, bias, s_next=None, pool=False) -> torch.Tensor:
    """Plain version: the exact int32 conv, then the epilogue in f32 tensor
    ops (and the 2×2 pool when pool); int8 with s_next, f32 without."""
    _check(x, w_packed, deq, bias, s_next, pool)
    acc = conv3x3_s32_ref(x, w_packed)
    if s_next is None:
        return dequant_epilogue(acc, deq, bias)
    q = requant_epilogue(acc, deq, bias, s_next)
    return pool2_int8(q) if pool else q


def conv3x3_s8(x, w_packed, deq, bias, s_next=None, pool=False) -> torch.Tensor:
    """(B, H, W, Cin) int8 x, packed int8 weights, (Cout,) f32 deq and bias,
    optional one-element f32 s_next → (B, H, W, Cout): int8 (requant) with
    s_next, f32 (dequant) without; with pool (requant only) the 2×2 VALID
    max-pool of it, (B, H // 2, W // 2, Cout). The kernel on a CUDA tensor,
    the plain version on a CPU tensor."""
    tensors = _check(x, w_packed, deq, bias, s_next, pool)
    if x.device.type == "cpu":
        return conv3x3_s8_ref(x, w_packed, deq, bias, s_next, pool)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_s8: unsupported device {x.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("conv3x3_s8: the kernel needs contiguous inputs")
    batch, h, wd, cin = x.shape
    if pool and cin % K_STEP:
        raise ValueError(f"conv3x3_s8: the kernel pools only for Cin a multiple of {K_STEP}, got {cin}")
    cout = w_packed.shape[0]
    shape = (batch, h // 2, wd // 2, cout) if pool else (batch, h, wd, cout)
    out = torch.empty(shape, device=x.device, dtype=torch.float32 if s_next is None else torch.int8)
    th, tw = tile_plan(h, wd, pool)
    with cuda_build.on_device(x.device):
        rc = _library().l3_int8_conv3x3(
            x.data_ptr(), w_packed.data_ptr(), deq.data_ptr(), bias.data_ptr(),
            None if s_next is None else s_next.data_ptr(), out.data_ptr(),
            batch, h, wd, cin, cout, w_packed.shape[1], int(pool), th, tw,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"int8 conv kernel launch failed: CUDA error {rc}")
    LAUNCHES["s8"] += 1
    return out
