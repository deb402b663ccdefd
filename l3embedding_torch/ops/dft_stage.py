"""Python side of ``csrc/dft_stage.cuh``, the DFT-product stage of both
front-end kernels' bf16 mode: its tile sizes, and the device layout of the
DFT bases it reads. (The f32 mode's FFT is ``fft_stage.py``.)"""

from __future__ import annotations

import ctypes

import numpy as np

# Frequency bins per chunk (FC in the source): the bases are zero-padded
# to a multiple of it. Frames per block (TM) sizes the tile-max scratch.
FREQ_CHUNK = 64
FRAMES_PER_BLOCK = 64
AMIN = 1e-10  # amplitude_to_db's defaults, which the plain versions use
DYNAMIC_RANGE = 80.0


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def pad_bins(real: np.ndarray, imag: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(n_dft, n_freq) bases → (n_dft, F_pad) f32, zero past n_freq, F_pad
    a FREQ_CHUNK multiple."""
    n_dft, n_freq = real.shape
    f_pad = round_up(n_freq, FREQ_CHUNK)
    w_re = np.zeros((n_dft, f_pad), np.float32)
    w_im = np.zeros((n_dft, f_pad), np.float32)
    w_re[:, :n_freq] = real
    w_im[:, :n_freq] = imag
    return w_re, w_im


def chunked(w_re: np.ndarray, w_im: np.ndarray) -> np.ndarray:
    """(n_dft, F_pad) padded bases → the kernel's layout (n_chunks, 2·FC,
    n_dft): each chunk's FC re rows, then its FC im rows."""
    n_dft, f_pad = w_re.shape
    n_chunks = f_pad // FREQ_CHUNK
    wt = np.concatenate(
        [
            w_re.T.reshape(n_chunks, FREQ_CHUNK, n_dft),
            w_im.T.reshape(n_chunks, FREQ_CHUNK, n_dft),
        ],
        axis=1,
    )
    return np.ascontiguousarray(wt)


def check_tiles(lib: ctypes.CDLL, prefix: str) -> None:
    """Raise unless the built library's tile sizes are this module's."""
    frames = getattr(lib, f"{prefix}_frames_per_block")
    bins = getattr(lib, f"{prefix}_bins_per_chunk")
    frames.restype = bins.restype = ctypes.c_int
    if (frames(), bins()) != (FRAMES_PER_BLOCK, FREQ_CHUNK):
        raise RuntimeError(f"{prefix}: the CUDA tile sizes disagree with dft_stage.py")
