"""The block-1 probe kernels as hand-written Hopper kernels, with their plain
versions.

Replace the TPU kernels of ``tools/pallas_block1_spike.py``:

  * ``gemm_probe`` ← ``bench_gemm``'s ``kernel``: the im2col GEMM of vision
    ``conv1_2`` with its operands resident on chip, repeated ``reps`` times,
    then ``·s + b`` and ReLU → bf16;
  * ``conv3x3_bn_relu`` ← ``_fused_kernel``: 3×3 SAME conv (64 → 64, NHWC
    bf16, f32 accumulation) → ``·scale + shift`` → ReLU → bf16, i.e.
    block-1 ``conv1_2`` with BN in eval form, on any (B, H, W, 64).

The CUDA source is ``l3embedding_torch/csrc/block1_conv.cu``; ``cuda_build``
compiles it with ``nvcc`` for ``sm_90a`` at first use. On an H100 the GEMM
probe is bound by operations (16.9 GFLOP at 64 reps, ~17 µs) and the conv at
(128, 224, 224, 64) by both limits at once (474 GFLOP, ~0.48 ms; 1.64 GB of
x and y, ~0.49 ms). Both are ``wgmma`` kernels fed by TMA with the 128-byte
swizzle, one operand held in registers for the kernel's life. The conv takes
the product transposed (64 output channels × TILE_W pixels): W^T is the
register operand, loaded once per CTA, and the input slab is read through
descriptors that start at each tap's shifted pixel. It is warp specialised:
a producer warpgroup copies each (TILE_H + 2) × (TILE_W + 2) input slab with one
4-D TMA load (zeros outside the image) into a STAGES-deep mbarrier ring, two
consumer warpgroups take the tiles in turn and store each through a
swizzled staging tile with one TMA store. The GEMM keeps
its 64-row A tile in registers for every rep and splits the reps over a
cluster of GEMM_SPLIT CTAs.

The conv weight is ``(576, 64)`` bf16 with rows in (dy, dx, ci) order, the
im2col column order of the spike (``compat.from_jax.block1_conv_from_jax``
makes it from a HWIO kernel). A CPU tensor goes to the plain version, a
CUDA tensor to the kernel; a CUDA tensor never falls back: a build or
launch failure raises.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter

import torch
import torch.nn.functional as F

from ..models.towers import ieee_fp32
from . import cuda_build

C = 64
K_DIM = 9 * C

# The kernels' work split, as csrc/block1_conv.cu fixes it (the CPU tests
# model the schedule with these and check them against the source): conv
# output tiles of TILE_H rows × TILE_W columns (one wgmma N a row; 224 =
# 4 × 56), STAGES slab buffers, the 128-byte swizzle span; the GEMM's 64-row
# tiles, each over a cluster of GEMM_SPLIT CTAs that share its reps, K in
# passes of GEMM_K_PASS.
TILE_H, TILE_W = 4, 56
STAGES = 3
SWIZZLE_BYTES = 128
GEMM_M_TILE = 64
GEMM_SPLIT = 2
GEMM_K_PASS = 576


# Launches of the CUDA kernels, by kernel ("block1_gemm", "block1_conv"):
# one per wrapper call on a CUDA tensor. LAUNCHES.clear() resets them.
LAUNCHES: Counter = Counter()


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load("block1_conv")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.l3_block1_gemm.argtypes = [p, p, p, p, p, i, i, i, i, p]
    lib.l3_block1_gemm.restype = i
    lib.l3_block1_conv.argtypes = [p, p, p, p, p, i, i, i, p]
    lib.l3_block1_conv.restype = i
    return lib


def _vector(name: str, v: torch.Tensor, n: int) -> torch.Tensor:
    if v.numel() != n or v.dtype != torch.float32:
        raise ValueError(f"{name}: need {n} float32 values, got {tuple(v.shape)} {v.dtype}")
    return v.reshape(n)


def _check_gemm(a, w, s, b, reps):
    if a.dim() != 2 or w.dim() != 2 or a.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(
            f"gemm_probe: need 2-D bfloat16 a and w, got {tuple(a.shape)} {a.dtype}, "
            f"{tuple(w.shape)} {w.dtype}"
        )
    (_, k), (k_w, n) = a.shape, w.shape
    if k != k_w or k % 64 or n not in (64, 128):
        raise ValueError(f"gemm_probe: need a (M, K), w (K, 64|128), K a multiple of 64; got "
                         f"{tuple(a.shape)}, {tuple(w.shape)}")
    if reps < 1:
        raise ValueError(f"gemm_probe: reps must be >= 1, got {reps}")
    return _vector("gemm_probe s", s, n), _vector("gemm_probe b", b, n)


def _check_conv(x, w, scale, shift):
    if x.dim() != 4 or x.shape[-1] != C or x.dtype != torch.bfloat16:
        raise ValueError(f"conv3x3_bn_relu: need x (B, H, W, {C}) bfloat16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if tuple(w.shape) != (K_DIM, C) or w.dtype != torch.bfloat16:
        raise ValueError(f"conv3x3_bn_relu: need w ({K_DIM}, {C}) bfloat16, got "
                         f"{tuple(w.shape)} {w.dtype}")
    return _vector("conv3x3_bn_relu scale", scale, C), _vector("conv3x3_bn_relu shift", shift, C)


def _device(name: str, *tensors: torch.Tensor) -> str:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs on several devices {sorted(map(str, devices))}")
    kind = devices.pop().type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {tensors[0].device}")
    return kind


def _contiguous(name: str, *tensors: torch.Tensor) -> None:
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: the kernel needs contiguous inputs")


def gemm_probe_ref(a, w, s, b, reps: int = 64) -> torch.Tensor:
    """Plain version: ``bench_gemm``'s kernel as written, nudge and all:
    Σ_i a·bf16(f32(w)·(1 + i·1e-8)) in f32, then ``·s + b``, ReLU, bf16.
    Needs TF32 off on the card (set here)."""
    s, b = _check_gemm(a, w, s, b, reps)
    acc = torch.zeros(a.shape[0], w.shape[1], dtype=torch.float32, device=a.device)
    a32 = a.float()
    with ieee_fp32(a.is_cuda):
        for i in range(reps):
            fac = 1.0 + torch.tensor(float(i), dtype=torch.float32) * 1e-8
            wi = (w.float() * fac).to(torch.bfloat16)
            acc = acc + a32 @ wi.float()
    return torch.relu(acc * s + b).to(torch.bfloat16)


def gemm_probe(a, w, s, b, reps: int = 64) -> torch.Tensor:
    """(M, K) bf16 a, (K, N) bf16 w, N f32 s and b → (M, N) bf16
    relu((Σ_{i<reps} a·w)·s + b): the kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    s, b = _check_gemm(a, w, s, b, reps)
    if _device("gemm_probe", a, w, s, b) == "cpu":
        return gemm_probe_ref(a, w, s, b, reps)
    _contiguous("gemm_probe", a, w, s, b)
    (m, k), n = a.shape, w.shape[1]
    out = torch.empty((m, n), device=a.device, dtype=torch.bfloat16)
    with torch.cuda.device(a.device):
        rc = _library().l3_block1_gemm(
            a.data_ptr(), w.data_ptr(), s.data_ptr(), b.data_ptr(), out.data_ptr(), m, k, n,
            reps, torch.cuda.current_stream(a.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"block1 GEMM kernel launch failed: CUDA error {rc}")
    LAUNCHES["block1_gemm"] += 1
    return out


def conv3x3_bn_relu_ref(x, w, scale, shift) -> torch.Tensor:
    """Plain version: f32 ``F.conv2d`` (SAME, on the bf16 values) →
    ``·scale + shift`` → ReLU → bf16, NHWC in and out. Needs TF32 off on
    the card (set here)."""
    scale, shift = _check_conv(x, w, scale, shift)
    w_oihw = w.float().reshape(3, 3, C, C).permute(3, 2, 0, 1)
    with ieee_fp32(x.is_cuda):
        y = F.conv2d(x.float().permute(0, 3, 1, 2), w_oihw, padding=1).permute(0, 2, 3, 1)
    return torch.relu(y * scale + shift).to(torch.bfloat16).contiguous()


def conv3x3_bn_relu(x, w, scale, shift) -> torch.Tensor:
    """(B, H, W, 64) bf16 x, (576, 64) bf16 w, (64,) f32 scale and shift →
    (B, H, W, 64) bf16 relu(conv3x3_SAME(x, w)·scale + shift): the kernel on
    a CUDA tensor, the plain version on a CPU tensor."""
    scale, shift = _check_conv(x, w, scale, shift)
    if _device("conv3x3_bn_relu", x, w, scale, shift) == "cpu":
        return conv3x3_bn_relu_ref(x, w, scale, shift)
    _contiguous("conv3x3_bn_relu", x, w, scale, shift)
    batch, h, wd, _ = x.shape
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = _library().l3_block1_conv(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), shift.data_ptr(), y.data_ptr(),
            batch, h, wd, torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"block1 conv kernel launch failed: CUDA error {rc}")
    LAUNCHES["block1_conv"] += 1
    return y
