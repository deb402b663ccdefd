"""Operations, bytes and peaks: the arithmetic behind the roofline and MFU
metrics, computed from the configuration's shapes alone.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W
limit): 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s float32 outside
them (the f32 cells keep TF32 off), 3.35 TB/s of HBM.

The front-end bound is the least time of the function at its shapes,
whatever algorithm computes it: the larger of its operations at the peak of
its precision and the bytes it must move at the HBM rate. The operations
are the real FFT of each frame (``fft_frame_flops``, a frozen copy of the
program's smoke test's count) and, for mel, the sparse filterbank sum; a
dense DFT product, which the bf16 kernel runs today, does some hundred times
more. The bytes are the PCM its windows cover, read once, and the features,
written once, each value at 2 bytes in bf16 and 4 in float32. So a faster
algorithm reads as a higher share, never as one over 100 %.
"""

from __future__ import annotations

import numpy as np

from .reference import dsp

PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
PEAK_HBM = 3.35e12


def frontend_shape(cfg: dict) -> tuple[int, int]:
    """(height, width) of the audio tower's input: (mel bands or bins, frames)."""
    a = cfg["audio"]
    frames = dsp.num_frames(a["n_samples"], a["n_dft"], a["hop"], a["padding"])
    return (a["n_mels"] if a["frontend"] == "mel" else a["n_dft"] // 2 + 1), frames


def _tower_macs(cfg: dict, h: int, w: int, cin: int, same_pool: bool) -> tuple[int, int]:
    """(MACs of every conv of a tower for one example, MACs of its first conv)."""
    k2 = cfg["kernel_size"] ** 2
    total, c, first = 0, cin, None
    for i, width in enumerate(cfg["widths"]):
        macs = h * w * c * width * k2
        first = macs if first is None else first
        total += macs
        c = width
        if i in cfg["pool_after"]:
            h, w = ((-(-h // 2), -(-w // 2)) if same_pool else (h // 2, w // 2))
    total += h * w * c * cfg["embedding_width"] * k2
    return total, first


def audio_macs(cfg: dict) -> tuple[int, int]:
    h, w = frontend_shape(cfg)
    return _tower_macs(cfg, h, w, 1, cfg["audio"]["pool"] == "same")


def vision_macs(cfg: dict) -> tuple[int, int]:
    h, w, c = cfg["vision"]["input"]
    return _tower_macs(cfg, h, w, c, cfg["vision"]["pool"] == "same")


def head_macs(cfg: dict) -> int:
    hidden = cfg["head"]["layer_size"]
    return 2 * cfg["embedding_width"] * hidden + hidden * cfg["head"]["classes"]


def window_flops(cfg: dict) -> float:
    """One window's extraction forward: 2 x the MACs of every audio conv."""
    return 2.0 * audio_macs(cfg)[0]


def pair_train_flops(cfg: dict) -> float:
    """One pair's train step: the forward (both towers and the head) three
    times, less each tower's first-conv input gradient, which nothing
    computes (its input takes no gradient)."""
    (a, a_first), (v, v_first) = audio_macs(cfg), vision_macs(cfg)
    return 2.0 * (3 * (a + v + head_macs(cfg)) - a_first - v_first)


def fft_frame_flops(n_dft: int) -> float:
    """Operations the f32 kernels' real FFT runs on one frame (a multiply or
    an add counts one): the window (n_dft products); the complex FFT of M =
    n_dft/2 points, whose first pass has no twiddles (radix 2 when log2 M is
    odd: 4 per butterfly; else radix 4: 16) and whose later radix-4 passes
    take three twiddle products a butterfly (34); the real post-pass with
    the power, 24 per pair of bins (k, M - k), k = 1..M/2, and 4 for bins 0
    and M."""
    m = n_dft // 2
    log2m = m.bit_length() - 1
    if log2m % 2:
        first, later = 4 * (m // 2), (log2m - 1) // 2
    else:
        first, later = 16 * (m // 4), log2m // 2 - 1
    return float(n_dft + first + later * 34 * (m // 4) + 24 * (m // 2) + 4)


def mel_csr(sr: int, n_dft: int, n_mels: int, fmin: float, htk: bool):
    """The filterbank as CSR rows from each filter's first nonzero bin to its
    last: (ptr int32 (n_mels + 1,), lo int32 (n_mels,), w float32 (nnz,))."""
    fb = dsp.mel_filterbank(sr, n_dft, n_mels, fmin, None, htk).astype(np.float32)
    ptr, lo, runs = np.zeros(n_mels + 1, np.int32), np.zeros(n_mels, np.int32), []
    for m in range(n_mels):
        nz = np.flatnonzero(fb[m])
        if nz.size:
            lo[m] = nz[0]
            runs.append(fb[m, nz[0]:nz[-1] + 1])
        ptr[m + 1] = ptr[m] + (nz[-1] + 1 - nz[0] if nz.size else 0)
    return ptr, lo, (np.concatenate(runs) if runs else np.zeros(0, np.float32))


def frontend_bound_s(rows: int, cfg: dict, fast: bool, span: int | None = None) -> float:
    """Least time of the front end (the mel or the linear spectrogram of
    the configuration) on `rows` windows cut from `span` samples of one
    clip: the real FFT of each frame, and for mel 2 operations a filterbank
    weight, at the peak of the precision (989 TFLOP/s bf16, 67 float32),
    or the PCM the windows cover read once and the features written once,
    a value 2 bytes in bf16 and 4 in float32, at the HBM rate: the larger."""
    a = cfg["audio"]
    n, n_dft = a["n_samples"], a["n_dft"]
    frames = dsp.num_frames(n, n_dft, a["hop"], a["padding"])
    per_frame = fft_frame_flops(n_dft)
    if a["frontend"] == "mel":
        per_frame += 2.0 * mel_csr(cfg["sr"], n_dft, a["n_mels"], a["fmin"], a["htk"])[2].size
    ops_s = rows * frames * per_frame / PEAK_FLOPS["bf16" if fast else "f32"]
    elem = 2 if fast else 4
    height = frontend_shape(cfg)[0]
    pcm = rows * n if span is None else min(rows * n, span)
    bytes_ = elem * (pcm + rows * height * frames)
    return max(ops_s, bytes_ / PEAK_HBM)
