"""The mel front-end as a hand-written Hopper kernel, with its plain version.

Replaces the TPU kernel ``l3embedding_tpu/ops/pallas_frontend.py::_mel_kernel``
(driven there by ``melspectrogram_fused``). The CUDA source is
``l3embedding_torch/csrc/mel_frontend.cu``; ``cuda_build`` compiles it with
``nvcc`` for ``sm_90a`` into ``build/l3torch_kernels/`` at first use and
loads it with ctypes. It has two modes, at the main path's shape (B=64,
199 frames, n_dft 2048, 1025 bins, 256 mels):

* ``fast=True``, the TPU kernel's numerics: the windowed DFT as a product
  with the DFT bases on the bf16 tensor cores (``csrc/dft_stage.cuh``:
  ``wgmma`` fed by a ring of bulk copies, bases laid out by
  ``dft_stage.py``; ~107 GFLOP at 989 TFLOP/s) and the mel sum over each
  filter's nonzero bins, cut at the DFT stage's chunk edges (~52 MFLOP):
  bound by operations, ~0.108 ms.
* ``fast=False``, the f32 parity configuration: a real FFT of each frame in
  shared memory (``csrc/fft_stage.cuh``, tables from ``fft_stage.py``) and
  the mel sum over each filter's nonzero bins only (CSR rows). ~0.73 GFLOP
  in all, ~0.0109 ms at 67 TFLOP/s, against ~25 MB of PCM and output
  (~0.0076 ms): bound by operations.

Both stage the waveform span of a block's frames once in shared memory and
take the per-sample dB max in a second pass; the source describes the
design.

``melspectrogram_fused`` takes a CUDA tensor to the kernel and a CPU tensor
to ``melspectrogram_fused_ref``, the tensor-op mirror of the same
function. A CUDA tensor never falls back: a build or launch failure, or an
n_dft that the f32 kernel's FFT does not take, raises.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter

import torch

from . import cuda_build, dft_stage, dsp_ref, fft_stage
from .dft_stage import AMIN, DYNAMIC_RANGE
from .frontend import MelConfig, amplitude_to_db, mel_matrix, power_frames, to_nhwc_db

# Launches of the CUDA kernel through melspectrogram_fused, by operand type
# ("bf16", "f32"): one per call (the mel kernel, plus its dB pass in the same
# call when decibel is on). LAUNCHES.clear() resets them.
LAUNCHES: Counter = Counter()


def _bases_key(cfg: MelConfig):
    return (cfg.sr, cfg.n_dft, cfg.n_mels, cfg.fmin, cfg.fmax, cfg.htk)


@functools.lru_cache(maxsize=None)
def _bf16_tables(key, device: str) -> tuple[torch.Tensor, ...]:
    """The bf16 kernel's tables on `device`: the basis stages
    (dft_stage.device_bases), and the filterbank's CSR rows cut at chunk
    edges (seg_ptr, segs) with their weights."""
    n_dft = key[1]
    ptr, lo, w = fft_stage.mel_csr(*key)
    seg_ptr, segs = dft_stage.mel_segments(ptr, lo, n_dft)
    wt = dft_stage.device_bases(n_dft, None, device)
    return (wt, *(torch.from_numpy(a).to(device) for a in (seg_ptr, segs, w)))


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load("mel_frontend")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.l3_mel_frontend_bf16.argtypes = [p, i, i, i, p, p, p, p, p, p, i, i, i, i, i, i, i, f, f, p]
    lib.l3_mel_frontend_f32.argtypes = [p, i, i, i, p, p, p, p, p, p, p, i, i, i, i, i, f, f, p]
    lib.l3_mel_frontend_bf16.restype = lib.l3_mel_frontend_f32.restype = i
    dft_stage.check_tiles(lib, "l3_mel")
    fft_stage.check_tiles(lib, "l3_mel")
    return lib


@functools.lru_cache(maxsize=64)  # call shapes in use; tables are cached apart
def _launch(cfg: MelConfig, batch: int, n: int, fast: bool, device: str):
    """What a call at (cfg, batch, n samples, mode, device) needs besides its
    tensors, made once: (entry point, table pointers, the arguments between
    tile_max and the stream, frames per block, n_frames, pad_left, tables).
    The tables are allocated here, before a first call's `out` (the order
    of the allocations decides where `out` lies in device memory)."""
    n_frames = cfg.n_frames(n)
    pad_left = dsp_ref.same_pad_amounts(n, cfg.n_dft, cfg.hop)[0] if cfg.padding == "same" else 0
    decibel = int(cfg.decibel and cfg.db_per_sample)
    if fast:
        tables = _bf16_tables(_bases_key(cfg), device)
        frames = dft_stage.frames_per_block(batch, n_frames, device)
        n_chunks = tables[0].shape[0]
        fn = _library().l3_mel_frontend_bf16
        mid = (cfg.n_dft, cfg.hop, n_frames, n_chunks, cfg.n_mels, frames)
    else:
        tables = fft_stage.device_tables(cfg.n_dft, None, device)
        tables += fft_stage.device_mel_csr(_bases_key(cfg), device)
        frames = fft_stage.FRAMES_PER_BLOCK
        fn = _library().l3_mel_frontend_f32
        mid = (cfg.n_dft, cfg.hop, n_frames, cfg.n_mels)
    ptrs = tuple(t.data_ptr() for t in tables)
    return fn, ptrs, mid + (decibel, AMIN, DYNAMIC_RANGE), frames, n_frames, pad_left, tables


def melspectrogram_fused_ref(
    x: torch.Tensor, cfg: MelConfig = MelConfig(), fast: bool = False
) -> torch.Tensor:
    """Plain tensor-op version of the kernel: (B, n) → (B, n_mels, T, 1).

    Operands bf16 (fast) or f32, f32 accumulation, f32 power and mel
    products, sqrt, then dB (per-sample, or batch-global when
    cfg.db_per_sample is False). Needs TF32 off on the card.
    """
    _check_cfg(cfg)
    p = power_frames(
        x, cfg.n_dft, cfg.hop, cfg.padding, torch.bfloat16 if fast else torch.float32
    )
    m = p @ torch.from_numpy(mel_matrix(cfg)).to(x.device)
    return to_nhwc_db(torch.sqrt(torch.clamp(m, min=0.0)), cfg)


def _check_cfg(cfg: MelConfig) -> None:
    if cfg.power_melgram != 1.0:
        raise NotImplementedError("the fused mel front-end implements power_melgram=1.0")


def check_kernel_cfg(cfg: MelConfig, fast: bool) -> None:
    """Raise ValueError for a configuration the CUDA kernel does not take,
    before any launch: n_mels 128 or 256; an even hop (the kernel reads each
    frame's sample pairs as aligned words); n_dft a multiple of 64 in bf16,
    a power of two in [64, 2048] in f32."""
    if cfg.n_mels not in (128, 256):
        raise ValueError(f"melspectrogram_fused: n_mels must be 128 or 256, got {cfg.n_mels}")
    if cfg.hop % 2:
        raise ValueError(f"melspectrogram_fused: need an even hop, got hop {cfg.hop}")
    if fast:
        dft_stage.check_n_dft(cfg.n_dft, "melspectrogram_fused")
    else:
        fft_stage.check_n_dft(cfg.n_dft, "melspectrogram_fused")


def melspectrogram_fused(
    x: torch.Tensor, cfg: MelConfig = MelConfig(), fast: bool = False
) -> torch.Tensor:
    """(B, n) f32 waveforms → (B, n_mels, T, 1) mel features.

    On a CUDA tensor: the hand-written kernel, bf16 DFT product (fast) or
    f32 FFT. The batch-global dB mode runs the kernel in amplitude mode and
    takes the batch max with tensor ops. On a CPU tensor: the plain
    version, which takes any configuration.

    The kernel takes n_mels 128 or 256, an even hop, and n_dft a multiple
    of 64 (fast) or a power of two in [64, 2048] (f32); any other
    configuration on a CUDA tensor raises ValueError before a launch
    (check_kernel_cfg).
    """
    _check_cfg(cfg)
    if x.device.type == "cpu":
        return melspectrogram_fused_ref(x, cfg, fast)
    if x.device.type != "cuda":
        raise ValueError(f"melspectrogram_fused: unsupported device {x.device}")
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(
            "melspectrogram_fused: need a contiguous (B, n) float32 tensor, got "
            f"{tuple(x.shape)} {x.dtype} contiguous={x.is_contiguous()}"
        )
    check_kernel_cfg(cfg, fast)
    batch, n = x.shape
    fn, ptrs, args, frames, n_frames, pad_left, _ = _launch(cfg, batch, n, fast, str(x.device))
    out = torch.empty((batch, cfg.n_mels, n_frames), device=x.device, dtype=torch.float32)
    tile_max = torch.empty((batch, -(-n_frames // frames)), device=x.device, dtype=torch.float32)
    with cuda_build.on_device(x.device):
        rc = fn(x.data_ptr(), batch, n, pad_left, *ptrs, out.data_ptr(), tile_max.data_ptr(),
                *args, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mel front-end kernel launch failed: CUDA error {rc}")
    LAUNCHES["bf16" if fast else "f32"] += 1
    out = out[..., None]
    if cfg.decibel and not cfg.db_per_sample:
        out = amplitude_to_db(out, AMIN, DYNAMIC_RANGE, per_sample=False)
    return out
