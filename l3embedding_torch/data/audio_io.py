"""Host-side audio IO (jax-free copies from ``l3embedding_tpu/data/audio_io.py``).

Decoding is layered, with no libsndfile:

  1. WAV through the stdlib ``wave`` module (PCM 8/16/24/32-bit).
  2. ``.npy`` / ``.npz`` pre-decoded arrays (the test and corpus-cache
     format): numpy alone.
  3. Anything else (flac/ogg/mp4/...) through an ``ffmpeg`` subprocess,
     when the binary is present; without it ``read_via_ffmpeg`` raises
     RuntimeError.

Resampling is polyphase (scipy.signal.resample_poly).
"""

from __future__ import annotations

import fractions
import os
import shutil
import subprocess
import wave

import numpy as np
import scipy.signal


def _ffmpeg_path():
    return shutil.which("ffmpeg")


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a PCM WAV file → (samples int16 (n, ch), sample_rate)."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2")
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.int16) - 128) << 8
    elif width == 4:
        data = (np.frombuffer(raw, dtype="<i4") >> 16).astype(np.int16)
    elif width == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        val = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        val = np.where(val >= 1 << 23, val - (1 << 24), val)
        data = (val >> 8).astype(np.int16)
    else:
        raise ValueError(f"unsupported WAV sample width: {width}")
    return data.reshape(-1, ch), sr


def read_via_ffmpeg(path: str, target_sr: int | None = None) -> tuple[np.ndarray, int]:
    """Decode any container to mono int16 PCM (n, 1) through ffmpeg, at
    target_sr (48000 when None)."""
    ffmpeg = _ffmpeg_path()
    if ffmpeg is None:
        raise RuntimeError(
            f"ffmpeg not available; cannot decode {path!r}. Provide WAV or "
            "pre-decoded .npy/.npz input instead."
        )
    sr = 48000 if target_sr is None else target_sr
    args = [ffmpeg, "-v", "error", "-i", path, "-f", "s16le", "-acodec",
            "pcm_s16le", "-ar", str(sr), "-ac", "1", "-"]
    out = subprocess.run(args, capture_output=True, check=True)
    return np.frombuffer(out.stdout, dtype="<i2").reshape(-1, 1), sr


def read_audio(path: str, dtype: str = "int16",
               target_sr: int | None = None) -> tuple[np.ndarray, int]:
    """Read audio → (samples (n, ch) int16, sr), format by extension
    (``dtype="float32"`` scales by 1/32768).

    target_sr only steers the ffmpeg fallback, which must pick some output
    rate; WAV, .npy (samples then the rate as the last element) and .npz
    (keys ``audio`` and ``sr``) return their own rate."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".wav":
        data, sr = read_wav(path)
    elif ext == ".npy":
        obj = np.load(path, allow_pickle=False)
        data, sr = obj[:-1].astype(np.int16).reshape(-1, 1), int(obj[-1])
    elif ext == ".npz":
        with np.load(path, allow_pickle=False) as obj:
            data = np.asarray(obj["audio"], dtype=np.int16)
            sr = int(obj["sr"])
        if data.ndim == 1:
            data = data.reshape(-1, 1)
    else:
        data, sr = read_via_ffmpeg(path, target_sr=target_sr)
    if dtype == "float32":
        data = data.astype(np.float32) / 32768.0
    return data, sr


def to_mono_int16(data: np.ndarray) -> np.ndarray:
    """Channel mean → int16 (reference sample.py:446-447 semantics)."""
    if data.ndim == 2:
        return data.mean(axis=-1).astype(np.int16)
    return data.astype(np.int16)


def resample(audio: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling along axis 0."""
    if sr == target_sr:
        return audio
    frac = fractions.Fraction(target_sr, sr)
    return scipy.signal.resample_poly(audio, frac.numerator, frac.denominator, axis=0)


def load_audio(path: str, target_sr: int) -> np.ndarray:
    """Load → mono float32 at target_sr (reference features.py:18-28)."""
    data, sr = read_audio(path, target_sr=target_sr)
    mono = data.astype(np.float64).mean(axis=-1) / 32768.0
    return resample(mono, sr, target_sr).astype(np.float32)


def pcm2float(sig: np.ndarray, dtype="float32") -> np.ndarray:
    """int PCM → [-1, 1) float (reference l3embedding/audio.py:1-31)."""
    sig = np.asarray(sig)
    if sig.dtype.kind not in "iu":
        raise TypeError("'sig' must be an array of integers")
    dtype = np.dtype(dtype)
    if dtype.kind != "f":
        raise TypeError("'dtype' must be a floating point type")
    i = np.iinfo(sig.dtype)
    abs_max = 2 ** (i.bits - 1)
    offset = i.min + abs_max
    return (sig.astype(dtype) - offset) / abs_max


def write_wav(path: str, data: np.ndarray, sr: int) -> None:
    """Write a 16-bit PCM WAV; float input in [-1, 1] is scaled by 32767."""
    data = np.asarray(data)
    if data.dtype != np.int16:
        data = (np.clip(data, -1.0, 1.0) * 32767.0).astype(np.int16)
    if data.ndim == 1:
        data = data.reshape(-1, 1)
    with wave.open(path, "wb") as w:
        w.setnchannels(data.shape[1])
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(data.tobytes())
