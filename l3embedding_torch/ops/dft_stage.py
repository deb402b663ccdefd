"""Python side of ``csrc/dft_stage.cuh``, the DFT-product stage of both
front-end kernels' bf16 mode: its tile sizes, the device layout of the DFT
bases it reads, and the mel kernel's chunk-cut filter table. (The f32
mode's FFT is ``fft_stage.py``.)

The bases are n_cols basis columns of n_dft values (K), re and im
interleaved: column 2f is re_f and 2f+1 is im_f, so a ``wgmma`` accumulator
holds the re and im of one bin in one thread's adjacent registers. Pair 0
holds (re_0, re_{N/2}) where n_dft is a multiple of a chunk's columns:
im_0 is exactly 0 and the dropped im_{N/2} = −sin(πt)·w[t] is below 5e-13,
so the columns are exactly n_dft. Otherwise (n_dft ≡ 64 mod 128) bin N/2
takes the first pair past n_dft, and zero columns fill the last chunk.

The columns are cut into chunks of COLS_PER_CHUNK and K into tiles of
K_TILE; each (chunk, K tile) is one 16 KB stage of the kernel's ring,
stored in the exact order the ``wgmma`` B descriptor reads from shared
memory (K-major, one 128-byte row per column, 128-byte swizzle), so one
bulk copy fills a stage.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .frontend import stft_basis_f32

COLS_PER_CHUNK = 128  # basis columns per chunk: the N of one wgmma (64 bins)
BINS_PER_CHUNK = COLS_PER_CHUNK // 2
K_TILE = 64  # K depth of one stage: 64 bf16 = one 128-byte row per column
MAX_SLOTS = 8  # mel partial sums carried from one chunk to the next (CARRY_SLOTS)
AMIN = 1e-10  # amplitude_to_db's defaults, which the plain versions use
DYNAMIC_RANGE = 80.0

# Flags of a mel segment (the kernel's SEG_FROM, SEG_TO).
SEG_FROM, SEG_TO = 1, 2


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def packed(n_dft: int) -> bool:
    """Whether bin N/2 shares pair 0 with bin 0 (n_dft a chunk multiple)."""
    return n_dft % COLS_PER_CHUNK == 0


def interleaved(real: np.ndarray, imag: np.ndarray) -> np.ndarray:
    """(n_dft, n_dft/2 + 1) bases → (n_cols, n_dft) f32 basis columns, re and
    im interleaved, DC and Nyquist packed into pair 0 where packed(n_dft),
    zero columns past the last pair."""
    n_dft, n_freq = real.shape
    half = n_freq - 1
    n_cols = round_up(n_dft + (0 if packed(n_dft) else 2), COLS_PER_CHUNK)
    w = np.zeros((n_cols, n_dft), np.float32)
    w[0 : 2 * half : 2] = real[:, :half].T
    w[1 : 2 * half : 2] = imag[:, :half].T
    if packed(n_dft):
        w[1] = real[:, half]  # im_0 is exactly 0
    else:
        w[2 * half] = real[:, half]
        w[2 * half + 1] = imag[:, half]
    return w


def unpack_pairs(w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Inverse of ``interleaved`` up to im_0 = 0 and, packed, im_{N/2} = 0:
    (n_cols, n_dft) → (real, imag), each (n_dft, n_dft/2 + 1)."""
    n_dft = w.shape[1]
    half = n_dft // 2
    real = np.zeros((n_dft, half + 1), w.dtype)
    imag = np.zeros((n_dft, half + 1), w.dtype)
    real[:, :half] = w[0 : 2 * half : 2].T
    imag[:, :half] = w[1 : 2 * half : 2].T
    if packed(n_dft):
        real[:, half] = w[1]
        imag[:, 0] = 0.0
    else:
        real[:, half] = w[2 * half]
        imag[:, half] = w[2 * half + 1]
    return real, imag


def swizzle_index(n: int | np.ndarray, k: int | np.ndarray):
    """Element offset of (column n, k) in a stage: row n of 64 values, its
    16-byte groups permuted by the 128-byte swizzle (group ^ n mod 8)."""
    return n * K_TILE + (((k // 8) ^ (n % 8)) * 8) + k % 8


def stage_tiles(w: np.ndarray) -> np.ndarray:
    """(n_cols, n_dft) columns → (n_chunks, n_ktiles, COLS_PER_CHUNK·K_TILE):
    each stage in its shared-memory order (``swizzle_index``)."""
    n_cols, n_dft = w.shape
    n_chunks, n_ktiles = n_cols // COLS_PER_CHUNK, n_dft // K_TILE
    tiles = w.reshape(n_chunks, COLS_PER_CHUNK, n_ktiles, K_TILE).transpose(0, 2, 1, 3)
    n, k = np.meshgrid(np.arange(COLS_PER_CHUNK), np.arange(K_TILE), indexing="ij")
    out = np.empty((n_chunks, n_ktiles, COLS_PER_CHUNK * K_TILE), w.dtype)
    out[..., swizzle_index(n, k)] = tiles
    return out


def descriptor_offset(n: int, k: int) -> int:
    """Byte offset from a stage's base at which the ``wgmma`` B descriptor
    finds (column n, k): the descriptor of K step k // 16 starts 32 bytes
    further per step, 8-column groups lie SBO = 1024 bytes apart and rows
    128 bytes apart, and the 128-byte swizzle then XORs address bits 4-6
    with bits 7-9 (the stage is 1024-byte aligned)."""
    logical = 32 * (k // 16) + 1024 * (n // 8) + 128 * (n % 8) + 2 * (k % 16)
    return logical ^ (((logical >> 7) & 7) << 4)


@functools.lru_cache(maxsize=None)
def _sm_count(device: str) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def frames_per_block(batch: int, n_frames: int, device: str) -> int:
    """Frames per block of a bf16 kernel launch: 128 (two consumer
    warpgroups share each basis stage, so the bases cross L2 once per 128
    frames), or 64 where the grid of 128-frame blocks would fill at most
    half of the card's SMs: the 64-frame grid, twice as many blocks, then
    still runs in one wave, and each block's own run of stages, not L2,
    sets the time (the AVC forward's batch of 8)."""
    if 2 * batch * -(-n_frames // 128) <= _sm_count(device):
        return 64
    return 128


def check_n_dft(n_dft: int, what: str) -> None:
    if n_dft % K_TILE:
        raise ValueError(f"{what}: the bf16 kernel needs n_dft a multiple of {K_TILE}, got {n_dft}")


@functools.lru_cache(maxsize=None)
def device_bases(n_dft: int, n_win: int | None, device: str) -> torch.Tensor:
    """The stage tiles of the ``interleaved`` windowed DFT bases, rounded
    once to bf16, on `device`."""
    w = interleaved(*stft_basis_f32(n_dft, n_win))
    return torch.from_numpy(stage_tiles(w)).to(device=device, dtype=torch.bfloat16).contiguous()


def bin_slot(b: int, n_dft: int) -> tuple[int, int]:
    """(chunk, row of the chunk's power tile) that holds bin b. Packed, bin
    N/2 comes out of chunk 0's pair 0 into row BINS_PER_CHUNK, which no
    later chunk writes; it is read with the last chunk, after bin N/2 − 1."""
    if packed(n_dft) and b == n_dft // 2:
        return n_dft // COLS_PER_CHUNK - 1, BINS_PER_CHUNK
    return b // BINS_PER_CHUNK, b % BINS_PER_CHUNK


def mel_segments(ptr: np.ndarray, lo: np.ndarray, n_dft: int) -> tuple[np.ndarray, np.ndarray]:
    """Cut the filterbank's CSR rows (``fft_stage.mel_csr``) at chunk edges.

    Returns (seg_ptr int32 (n_chunks+1,), segs int32 (n_segs, 4)): chunk c
    sums segments seg_ptr[c]:seg_ptr[c+1]. A segment (m | slot << 16 |
    flags << 24, row, length, weight offset) adds mel_w[off + j] · P[row +
    j] for j < length to filter m's sum; SEG_FROM starts from the partial
    sum carried in `slot`, SEG_TO carries the sum on in `slot`, and without
    SEG_TO the filter is finished and written. A slot freed in a chunk is
    taken again only from the next chunk on, so the segments of one chunk
    can run in any order. An empty filter is one segment of length 0 in
    chunk 0."""
    n_chunks = round_up(n_dft + (0 if packed(n_dft) else 2), COLS_PER_CHUNK) // COLS_PER_CHUNK
    per_chunk: list[list[tuple]] = [[] for _ in range(n_chunks)]
    busy_until = [-1] * MAX_SLOTS  # last chunk that reads the slot
    for m in range(len(lo)):
        o0, o1 = int(ptr[m]), int(ptr[m + 1])
        if o0 == o1:
            per_chunk[0].append((m, 0, 0, 0, o0, 0))
            continue
        runs = []  # (chunk, row, length, offset)
        for o in range(o0, o1):
            c, r = bin_slot(int(lo[m]) + o - o0, n_dft)
            if runs and runs[-1][0] == c and runs[-1][1] + runs[-1][2] == r:
                runs[-1][2] += 1
            else:
                runs.append([c, r, 1, o])
        slot = 0
        if len(runs) > 1:
            slot = next((s for s in range(MAX_SLOTS) if busy_until[s] < runs[0][0]), None)
            if slot is None:
                raise ValueError("mel_segments: more filters cross a chunk edge than carry slots")
            busy_until[slot] = runs[-1][0]
        for i, (c, r, length, off) in enumerate(runs):
            if i and runs[i - 1][0] == c:
                raise ValueError("mel_segments: a filter's bins are not contiguous within a chunk")
            flags = (SEG_FROM if i else 0) | (SEG_TO if i < len(runs) - 1 else 0)
            per_chunk[c].append((m, slot, flags, r, off, length))
    seg_ptr = np.zeros(n_chunks + 1, np.int32)
    rows = []
    for c, segs in enumerate(per_chunk):
        for m, slot, flags, r, off, length in segs:
            rows.append((m | slot << 16 | flags << 24, r, length, off))
        seg_ptr[c + 1] = len(rows)
    return seg_ptr, np.asarray(rows, np.int32).reshape(-1, 4)


def check_tiles(lib: ctypes.CDLL, prefix: str) -> None:
    """Raise unless the built library's basis columns per chunk are this
    module's."""
    cols = getattr(lib, f"{prefix}_cols_per_chunk")
    cols.restype = ctypes.c_int
    if cols() != COLS_PER_CHUNK:
        raise RuntimeError(f"{prefix}: the CUDA chunk width disagrees with dft_stage.py")
