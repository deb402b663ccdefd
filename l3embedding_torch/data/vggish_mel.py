"""VGGish mel front-end: waveform → (N, 96, 64) log-mel example patches
(a copy of ``l3embedding_tpu/data/vggish_mel.py``; numpy only).

Numpy reimplementation of the reference's vendored Google code
(reference data/usc/vggish/mel_features.py:21-218, vggish_input.py:25-75)
with the same semantics, which differ from the L3 (librosa-style) mel in
three ways: the mel matrix is pure HTK triangles with NO area
normalization, the DC bin row is zeroed, and the output is
log(mel + log_offset) of *magnitude* (not power) spectrograms.

Defaults follow vggish_params.py: 16 kHz, 25 ms window (400 samples),
10 ms hop (160), fft 512, 64 bands over 125-7500 Hz, log offset 0.01,
0.96 s example windows with no overlap.
"""

from __future__ import annotations

import numpy as np

SAMPLE_RATE = 16000
STFT_WINDOW_LENGTH_SECONDS = 0.025
STFT_HOP_LENGTH_SECONDS = 0.010
NUM_MEL_BINS = 64
MEL_MIN_HZ = 125
MEL_MAX_HZ = 7500
LOG_OFFSET = 0.01
EXAMPLE_WINDOW_SECONDS = 0.96
EXAMPLE_HOP_SECONDS = 0.96

_MEL_BREAK_FREQUENCY_HERTZ = 700.0
_MEL_HIGH_FREQUENCY_Q = 1127.0


def frame(data: np.ndarray, window_length: int, hop_length: int) -> np.ndarray:
    """Stride-trick framing along axis 0 (drops the partial tail frame)."""
    num_frames = 1 + int(np.floor((data.shape[0] - window_length) / hop_length))
    shape = (num_frames, window_length) + data.shape[1:]
    strides = (data.strides[0] * hop_length,) + data.strides
    return np.lib.stride_tricks.as_strided(data, shape=shape, strides=strides)


def periodic_hann(window_length: int) -> np.ndarray:
    return 0.5 - 0.5 * np.cos(
        2 * np.pi / window_length * np.arange(window_length)
    )


def stft_magnitude(signal, fft_length, hop_length, window_length):
    frames = frame(signal, window_length, hop_length)
    window = periodic_hann(window_length)
    return np.abs(np.fft.rfft(frames * window, int(fft_length)))


def hertz_to_mel(frequencies_hertz):
    return _MEL_HIGH_FREQUENCY_Q * np.log(
        1.0 + (np.asarray(frequencies_hertz, dtype=float) / _MEL_BREAK_FREQUENCY_HERTZ)
    )


def spectrogram_to_mel_matrix(
    num_mel_bins=20,
    num_spectrogram_bins=129,
    audio_sample_rate=8000,
    lower_edge_hertz=125.0,
    upper_edge_hertz=3800.0,
):
    """HTK triangular mel matrix, (num_spectrogram_bins, num_mel_bins):
    unnormalized triangles linear in mel, DC row zeroed."""
    nyquist = audio_sample_rate / 2.0
    if lower_edge_hertz >= upper_edge_hertz:
        raise ValueError(
            f"lower_edge_hertz {lower_edge_hertz:.1f} >= "
            f"upper_edge_hertz {upper_edge_hertz:.1f}"
        )
    bins_mel = hertz_to_mel(np.linspace(0.0, nyquist, num_spectrogram_bins))
    band_edges = np.linspace(
        hertz_to_mel(lower_edge_hertz),
        hertz_to_mel(upper_edge_hertz),
        num_mel_bins + 2,
    )
    lower = band_edges[:-2][None, :]
    center = band_edges[1:-1][None, :]
    upper = band_edges[2:][None, :]
    m = bins_mel[:, None]
    lower_slope = (m - lower) / (center - lower)
    upper_slope = (upper - m) / (upper - center)
    weights = np.maximum(0.0, np.minimum(lower_slope, upper_slope))
    weights[0, :] = 0.0
    return weights


def log_mel_spectrogram(
    data,
    audio_sample_rate=8000,
    log_offset=0.0,
    window_length_secs=0.025,
    hop_length_secs=0.010,
    **kwargs,
):
    window_length = int(round(audio_sample_rate * window_length_secs))
    hop_length = int(round(audio_sample_rate * hop_length_secs))
    fft_length = 2 ** int(np.ceil(np.log(window_length) / np.log(2.0)))
    spec = stft_magnitude(data, fft_length, hop_length, window_length)
    mel = spec @ spectrogram_to_mel_matrix(
        num_spectrogram_bins=spec.shape[1],
        audio_sample_rate=audio_sample_rate,
        **kwargs,
    )
    return np.log(mel + log_offset)


def waveform_to_examples(
    data,
    sample_rate,
    target_sample_rate=SAMPLE_RATE,
    log_offset=LOG_OFFSET,
    stft_win_len_sec=STFT_WINDOW_LENGTH_SECONDS,
    stft_hop_len_sec=STFT_HOP_LENGTH_SECONDS,
    num_mel_bins=NUM_MEL_BINS,
    mel_min_hz=MEL_MIN_HZ,
    mel_max_hz=MEL_MAX_HZ,
    frame_win_sec=EXAMPLE_WINDOW_SECONDS,
    frame_hop_sec=EXAMPLE_HOP_SECONDS,
    **params,
):
    """waveform → (num_examples, 96, 64) log-mel patches
    (reference vggish_input.py:25-75)."""
    data = np.asarray(data)
    if data.ndim > 1:
        data = np.mean(data, axis=1)
    if sample_rate != target_sample_rate:
        from .audio_io import resample

        data = resample(data, sample_rate, target_sample_rate)

    log_mel = log_mel_spectrogram(
        data,
        audio_sample_rate=target_sample_rate,
        log_offset=log_offset,
        window_length_secs=stft_win_len_sec,
        hop_length_secs=stft_hop_len_sec,
        num_mel_bins=num_mel_bins,
        lower_edge_hertz=mel_min_hz,
        upper_edge_hertz=mel_max_hz,
    )
    features_sample_rate = 1.0 / stft_hop_len_sec
    window_length = int(round(frame_win_sec * features_sample_rate))
    hop_length = int(round(frame_hop_sec * features_sample_rate))
    return frame(log_mel, window_length=window_length, hop_length=hop_length)
