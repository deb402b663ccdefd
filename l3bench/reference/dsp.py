"""Numpy DSP constants and basis constructors of the benchmark's plain
reference: a frozen copy of the float64 formulas of the L3 front ends
(windowed DFT bank, HTK mel filterbank with Slaney area normalisation,
TF-SAME framing), as kapre 0.1.4 and the reference's
``l3embedding/audio_model.py`` define them. It imports nothing of the
program under test, so the yardstick stays fixed when the program changes.
"""

from __future__ import annotations

import numpy as np

L3_SAMPLE_RATE = 48000
L3_N_DFT_LINEAR = 512
L3_N_DFT_MEL = 2048
L3_HOP = 242


def periodic_hann(n: int) -> np.ndarray:
    """Periodic ("fftbins") Hann window of length n, float64."""
    if n <= 0:
        return np.zeros(0)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


def centred_hann(n_dft: int, n_win: int | None = None) -> np.ndarray:
    """The periodic Hann window of n_win samples (default n_dft) centred
    in an n_dft-sample frame, zero outside it; float64."""
    if n_win is None:
        n_win = n_dft
    window = np.zeros(n_dft)
    lpad = (n_dft - n_win) // 2
    window[lpad:lpad + n_win] = periodic_hann(n_win)
    return window


def stft_basis(n_dft: int, n_win: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Windowed DFT bases (real, imag), each (n_dft, n_dft//2 + 1).

    For a frame x: re = x @ real, im = x @ imag. The Hann window of
    length n_win (default n_dft) is centred in the n_dft-sample frame.
    """
    n_freq = n_dft // 2 + 1
    t = np.arange(n_dft)[:, None]
    k = np.arange(n_freq)[None, :]
    angle = 2.0 * np.pi * t * k / n_dft
    window = centred_hann(n_dft, n_win)
    real = np.cos(angle) * window[:, None]
    imag = -np.sin(angle) * window[:, None]
    return real, imag


def num_frames(n: int, n_dft: int, hop: int, padding: str) -> int:
    """Conv-style output length for the framing op."""
    if padding == "valid":
        return (n - n_dft) // hop + 1
    if padding == "same":
        return -(-n // hop)  # ceil
    raise ValueError(f"padding must be 'valid' or 'same', got {padding!r}")


def same_pad_amounts(n: int, n_dft: int, hop: int) -> tuple[int, int]:
    """TF-SAME left/right zero-pad amounts for the framing op."""
    frames = num_frames(n, n_dft, hop, "same")
    total = max((frames - 1) * hop + n_dft - n, 0)
    left = total // 2
    return left, total - left


def hz_to_mel(f, htk: bool = True):
    f = np.asarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    if np.ndim(f) == 0:
        if f >= min_log_hz:
            mels = min_log_mel + np.log(f / min_log_hz) / logstep
    else:
        log_t = f >= min_log_hz
        mels[log_t] = min_log_mel + np.log(f[log_t] / min_log_hz) / logstep
    return mels


def mel_to_hz(m, htk: bool = True):
    m = np.asarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = m >= min_log_mel
    freqs[log_t] = min_log_hz * np.exp(logstep * (m[log_t] - min_log_mel))
    return freqs


def mel_filterbank(
    sr: int,
    n_dft: int,
    n_mels: int = 128,
    fmin: float = 0.0,
    fmax: float | None = None,
    htk: bool = True,
    norm: str | None = "slaney",
) -> np.ndarray:
    """Triangular mel filterbank, (n_mels, n_dft//2 + 1), librosa-style."""
    if fmax is None:
        fmax = sr / 2.0
    n_freq = n_dft // 2 + 1
    fftfreqs = np.linspace(0.0, sr / 2.0, n_freq)
    mel_pts = mel_to_hz(
        np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk), n_mels + 2), htk
    )
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    if norm == "slaney":
        enorm = 2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels])
        weights *= enorm[:, None]
    return weights
