"""Python side of ``csrc/fft_stage.cuh``, the real FFT that both front-end
kernels run in f32 (``fast=False``): its frames per block, the frame sizes
it takes, and the host tables it reads.

Every table is built in float64 and rounded once to f32: the complex
FFT's twiddles, the real post-pass's twiddles, the window, and the mel
filterbank as CSR rows (one contiguous run of bins per filter). Device
copies are cached per device.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import dsp_ref
from .frontend import mel_matrix_f32

# Frames per block (FFT_FRAMES in the source): sizes the tile-max scratch.
FRAMES_PER_BLOCK = 16
# The frame sizes the kernels are built for: powers of two in this range
# (the largest keeps a warp's buffer and registers at 1024 complex points).
MIN_N_DFT, MAX_N_DFT = 64, 2048


def check_n_dft(n_dft: int, what: str) -> None:
    """Raise ValueError unless the FFT takes frames of n_dft samples."""
    if not MIN_N_DFT <= n_dft <= MAX_N_DFT or n_dft & (n_dft - 1):
        raise ValueError(
            f"{what}: the f32 kernel's FFT needs n_dft a power of two in "
            f"[{MIN_N_DFT}, {MAX_N_DFT}], got {n_dft}"
        )


@functools.lru_cache(maxsize=None)
def twiddles(n_dft: int) -> np.ndarray:
    """(2, n_dft/2, 2) f32 (re, im) pairs: [0] the complex FFT's
    e^{−2πij/(n_dft/2)}, [1] the real post-pass's e^{−2πik/n_dft}, for
    j, k < n_dft/2."""
    m = n_dft // 2
    angles = -2.0 * np.pi * np.arange(m) / np.array([[m], [n_dft]])
    return np.stack([np.cos(angles), np.sin(angles)], axis=-1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def window(n_dft: int, n_win: int | None = None) -> np.ndarray:
    """(n_dft,) f32: the periodic Hann window of n_win centred in n_dft."""
    return dsp_ref.centred_hann(n_dft, n_win).astype(np.float32)


@functools.lru_cache(maxsize=None)
def mel_csr(sr, n_dft, n_mels, fmin, fmax, htk) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The filterbank ``mel_matrix_f32`` as CSR rows: filter m has the
    weights w[ptr[m]:ptr[m+1]] on bins lo[m], lo[m]+1, … (from its first
    nonzero bin to its last); an empty filter has ptr[m] == ptr[m+1].
    Returns (ptr int32 (n_mels+1,), lo int32 (n_mels,), w f32 (nnz,))."""
    mel_t = mel_matrix_f32(sr, n_dft, n_mels, fmin, fmax, htk)
    ptr = np.zeros(n_mels + 1, np.int32)
    lo = np.zeros(n_mels, np.int32)
    runs = []
    for m in range(n_mels):
        nz = np.flatnonzero(mel_t[:, m])
        if nz.size:
            lo[m] = nz[0]
            runs.append(mel_t[nz[0] : nz[-1] + 1, m])
        ptr[m + 1] = ptr[m] + (nz[-1] + 1 - nz[0] if nz.size else 0)
    w = np.concatenate(runs) if runs else np.zeros(0, np.float32)
    return ptr, lo, w


@functools.lru_cache(maxsize=None)
def device_tables(n_dft: int, n_win: int | None, device: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(window, twiddles) on `device`."""
    return (
        torch.from_numpy(window(n_dft, n_win)).to(device),
        torch.from_numpy(twiddles(n_dft)).to(device),
    )


@functools.lru_cache(maxsize=None)
def device_mel_csr(key, device: str) -> tuple[torch.Tensor, ...]:
    """mel_csr(*key) on `device`: (ptr, lo, w)."""
    return tuple(torch.from_numpy(a).to(device) for a in mel_csr(*key))


def check_tiles(lib: ctypes.CDLL, prefix: str) -> None:
    """Raise unless the built library's FFT frames per block are this
    module's."""
    frames = getattr(lib, f"{prefix}_fft_frames_per_block")
    frames.restype = ctypes.c_int
    if frames() != FRAMES_PER_BLOCK:
        raise RuntimeError(f"{prefix}: the CUDA FFT tile size disagrees with fft_stage.py")
