"""The linear-spectrogram front-end as a hand-written Hopper kernel, with
its plain version.

Replaces the TPU kernel ``l3embedding_tpu/ops/pallas_frontend.py::_spec_kernel``
(driven there by ``spectrogram_fused``), the front end of cnn_L3_orig
(amplitude, then the caller's ``l3_log_norm``), cnn_L3_kapredbinputbn (dB)
and tiny_L3 (dB, n_dft 512, hop 240, a 480-sample window). The CUDA source
is ``l3embedding_torch/csrc/spec_frontend.cu``, which shares its stages
with the mel kernel; ``cuda_build`` compiles it with ``nvcc`` for
``sm_90a`` at first use. At the main path's shape (B=64, 197 frames,
n_dft 512, 257 bins) both modes are bound by bytes (~25 MB of PCM and f32
output, ~7.5 µs):

* ``fast=True``: the windowed DFT as a product with the bases on the bf16
  tensor cores (``csrc/dft_stage.cuh``: ``wgmma`` fed by a ring of bulk
  copies, bases laid out by ``dft_stage.py``; ~6.6 GFLOP, ~7 µs at 989
  TFLOP/s), the TPU kernel's numerics;
* ``fast=False``: a real FFT of each frame in shared memory
  (``csrc/fft_stage.cuh``, tables from ``fft_stage.py``; ~0.14 GFLOP,
  ~2.1 µs at 67 TFLOP/s), the f32 parity configuration.

``spectrogram_fused`` takes a CUDA tensor to the kernel and a CPU tensor
to ``spectrogram_fused_ref``, the tensor-op mirror of the same function.
A CUDA tensor never falls back: a build or launch failure, or an n_dft
that the f32 kernel's FFT does not take, raises.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter

import torch

from . import cuda_build, dft_stage, dsp_ref, fft_stage
from .dft_stage import AMIN, DYNAMIC_RANGE
from .frontend import SpectrogramConfig, amplitude_to_db, power_frames, to_nhwc_db

# Launches of the CUDA kernel through spectrogram_fused, by operand type
# ("bf16", "f32"): one per call (the kernel, plus its dB pass in the same
# call when per-sample dB is on). LAUNCHES.clear() resets them.
LAUNCHES: Counter = Counter()


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load("spec_frontend")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.l3_spec_frontend_bf16.argtypes = [p, i, i, i, p, p, p, i, i, i, i, i, i, f, i, f, f, p]
    lib.l3_spec_frontend_f32.argtypes = [p, i, i, i, p, p, p, p, i, i, i, f, i, f, f, p]
    lib.l3_spec_frontend_bf16.restype = lib.l3_spec_frontend_f32.restype = i
    dft_stage.check_tiles(lib, "l3_spec")
    fft_stage.check_tiles(lib, "l3_spec")
    return lib


@functools.lru_cache(maxsize=64)  # call shapes in use; tables are cached apart
def _launch(cfg: SpectrogramConfig, batch: int, n: int, fast: bool, device: str):
    """What a call at (cfg, batch, n samples, mode, device) needs besides its
    tensors, made once: (entry point, table pointers, the arguments between
    tile_max and the stream, frames per block, n_frames, pad_left, tables).
    The tables are allocated here, before a first call's `out` (the order
    of the allocations decides where `out` lies in device memory)."""
    n_frames = cfg.n_frames(n)
    pad_left = dsp_ref.same_pad_amounts(n, cfg.n_dft, cfg.hop)[0] if cfg.padding == "same" else 0
    tail = (float(cfg.power), int(cfg.decibel and cfg.db_per_sample), AMIN, DYNAMIC_RANGE)
    if fast:
        tables = (dft_stage.device_bases(cfg.n_dft, cfg.n_win, device),)
        frames = dft_stage.frames_per_block(batch, n_frames, device)
        fn = _library().l3_spec_frontend_bf16
        mid = (cfg.n_dft, cfg.hop, n_frames, cfg.n_freq, tables[0].shape[0], frames)
    else:
        tables = fft_stage.device_tables(cfg.n_dft, cfg.n_win, device)
        frames = fft_stage.FRAMES_PER_BLOCK
        fn = _library().l3_spec_frontend_f32
        mid = (cfg.n_dft, cfg.hop, n_frames)
    ptrs = tuple(t.data_ptr() for t in tables)
    return fn, ptrs, mid + tail, frames, n_frames, pad_left, tables


def _check_cfg(cfg: SpectrogramConfig) -> None:
    # The kernel reads each frame's sample pairs as aligned words (hop even)
    # and, in bf16, stages the bases in K tiles of 64.
    if cfg.hop % 2 or cfg.n_dft % 64:
        raise ValueError(
            f"spectrogram_fused: need an even hop and n_dft a multiple of 64, "
            f"got hop {cfg.hop}, n_dft {cfg.n_dft}"
        )


def _power(p: torch.Tensor, power: float) -> torch.Tensor:
    if power == 1.0:
        return torch.sqrt(p)
    if power == 2.0:
        return p
    return p ** (power / 2.0)


def spectrogram_fused_ref(
    x: torch.Tensor, cfg: SpectrogramConfig = SpectrogramConfig(), fast: bool = False
) -> torch.Tensor:
    """Plain tensor-op version of the kernel: (B, n) → (B, n_freq, T, 1).

    Operands bf16 (fast) or f32, f32 accumulation, f32 power, then sqrt
    (power 1), nothing (power 2) or ^(power/2), then dB when cfg.decibel
    (per-sample, or batch-global when cfg.db_per_sample is False). Needs
    TF32 off on the card.
    """
    _check_cfg(cfg)
    dtype = torch.bfloat16 if fast else torch.float32
    p = power_frames(x, cfg.n_dft, cfg.hop, cfg.padding, dtype, cfg.n_win)
    return to_nhwc_db(_power(p, cfg.power), cfg)


def spectrogram_fused(
    x: torch.Tensor, cfg: SpectrogramConfig = SpectrogramConfig(), fast: bool = False
) -> torch.Tensor:
    """(B, n) f32 waveforms → (B, n_freq, T, 1) |STFT|^power (+ dB).

    On a CUDA tensor: the hand-written kernel, bf16 DFT product (fast) or
    f32 FFT. The batch-global dB mode runs the kernel in amplitude mode and
    takes the batch max with tensor ops. On a CPU tensor: the plain
    version.

    Both take an even hop and n_dft a multiple of 64; the kernel's f32 mode
    also needs n_dft a power of two in [64, 2048]. Any other configuration
    raises ValueError before a launch.
    """
    _check_cfg(cfg)
    if x.device.type == "cpu":
        return spectrogram_fused_ref(x, cfg, fast)
    if x.device.type != "cuda":
        raise ValueError(f"spectrogram_fused: unsupported device {x.device}")
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(
            "spectrogram_fused: need a contiguous (B, n) float32 tensor, got "
            f"{tuple(x.shape)} {x.dtype} contiguous={x.is_contiguous()}"
        )
    batch, n = x.shape
    n_frames = cfg.n_frames(n)
    if n_frames < 1:
        raise ValueError(f"spectrogram_fused: {n} samples give no frame of {cfg.n_dft}")
    if not fast:
        fft_stage.check_n_dft(cfg.n_dft, "spectrogram_fused")
    fn, ptrs, args, frames, n_frames, pad_left, _ = _launch(cfg, batch, n, fast, str(x.device))
    out = torch.empty((batch, cfg.n_freq, n_frames), device=x.device, dtype=torch.float32)
    tile_max = torch.empty((batch, -(-n_frames // frames)), device=x.device, dtype=torch.float32)
    with cuda_build.on_device(x.device):
        rc = fn(x.data_ptr(), batch, n, pad_left, *ptrs, out.data_ptr(), tile_max.data_ptr(),
                *args, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"spectrogram kernel launch failed: CUDA error {rc}")
    LAUNCHES["bf16" if fast else "f32"] += 1
    out = out[..., None]
    if cfg.decibel and not cfg.db_per_sample:
        out = amplitude_to_db(out, AMIN, DYNAMIC_RANGE, per_sample=False)
    return out
