"""Plain PyTorch mel and linear front-ends (the port of ``l3embedding_tpu/ops/frontend.py``).

    waveform --frame (unfold)--> (B, T, n_dft) --matmul--> DFT re/im
             --square+add--> power --matmul--> mel --sqrt--> dB features

These are tensor-op versions, run on whatever device their input lies
on. The model's front end on the card is a hand-written kernel
(``mel_kernel.py``, ``spec_kernel.py``); these functions are its
references and the CPU path's building blocks. ``melspectrogram_int8dft``
is the int8 tower's front end (the DFT s8 × s8 → s32: ``torch._int_mm`` on
the card, an exact float64 product on the CPU). Waveforms are (B, n_samples) float32 in [-1, 1];
outputs are (B, n_mels or n_freq, n_frames, 1), the JAX package's NHWC
layout.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from . import dsp_ref


@dataclass(frozen=True)
class SpectrogramConfig:
    """Linear-spectrogram front-end configuration (cnn_L3_orig defaults)."""

    n_dft: int = dsp_ref.L3_N_DFT_LINEAR
    hop: int = dsp_ref.L3_HOP
    padding: str = "valid"
    power: float = 1.0
    n_win: int | None = None
    decibel: bool = False
    db_per_sample: bool = True

    @property
    def n_freq(self) -> int:
        return self.n_dft // 2 + 1

    def n_frames(self, n_samples: int) -> int:
        return dsp_ref.num_frames(n_samples, self.n_dft, self.hop, self.padding)


@dataclass(frozen=True)
class MelConfig:
    """Mel-spectrogram front-end configuration.

    Defaults are cnn_L3_melspec1's (n_mels=128); melspec2 uses 256.
    db_per_sample=False reproduces kapre<=0.1.x's batch-global dB max.
    """

    sr: int = dsp_ref.L3_SAMPLE_RATE
    n_dft: int = dsp_ref.L3_N_DFT_MEL
    hop: int = dsp_ref.L3_HOP
    n_mels: int = 128
    padding: str = "same"
    power_melgram: float = 1.0
    htk: bool = True
    decibel: bool = True
    fmin: float = 0.0
    fmax: float | None = None
    db_per_sample: bool = True

    def n_frames(self, n_samples: int) -> int:
        return dsp_ref.num_frames(n_samples, self.n_dft, self.hop, self.padding)


@functools.lru_cache(maxsize=None)
def stft_basis_f32(n_dft: int, n_win: int | None = None):
    real, imag = dsp_ref.stft_basis(n_dft, n_win)
    return real.astype(np.float32), imag.astype(np.float32)


@functools.lru_cache(maxsize=None)
def mel_matrix_f32(sr, n_dft, n_mels, fmin, fmax, htk) -> np.ndarray:
    """(n_freq, n_mels): the filterbank transposed for frames-major matmuls."""
    return dsp_ref.mel_filterbank(sr, n_dft, n_mels, fmin, fmax, htk).T.astype(
        np.float32
    )


def mel_matrix(cfg: MelConfig) -> np.ndarray:
    return mel_matrix_f32(cfg.sr, cfg.n_dft, cfg.n_mels, cfg.fmin, cfg.fmax, cfg.htk)


def as_operand(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Round to the operand type and back to f32: a f32 matmul of the
    result is exactly a `dtype`-operand product with f32 accumulation
    (a bf16 x bf16 product is exact in f32)."""
    return x.to(dtype).float() if dtype != torch.float32 else x.float()


def frame_signal(x: torch.Tensor, n_dft: int, hop: int, padding: str) -> torch.Tensor:
    """(B, n) waveforms → (B, n_frames, n_dft) overlapping frames (a view
    of the TF-SAME-padded waveform)."""
    if padding == "same":
        left, right = dsp_ref.same_pad_amounts(x.shape[-1], n_dft, hop)
        x = F.pad(x, (left, right))
    return x.unfold(-1, n_dft, hop)


# The process group whose global batch a batch-global dB reference spans
# (``batch_global_db``); None: this process's batch.
_DB_GROUP: contextvars.ContextVar = contextvars.ContextVar("db_group", default=None)


@contextlib.contextmanager
def batch_global_db(group):
    """Within the block, ``amplitude_to_db(per_sample=False)`` takes its
    reference over the global batch of `group`'s ranks: this batch's max,
    all-reduced with MAX over them (JAX's max over a batch sharded on the
    mesh). None, or a group of one, leaves the one-process path."""
    if group is not None and dist.get_world_size(group) == 1:
        group = None
    token = _DB_GROUP.set(group)
    try:
        yield
    finally:
        _DB_GROUP.reset(token)


def amplitude_to_db(
    x: torch.Tensor,
    amin: float = 1e-10,
    dynamic_range: float = 80.0,
    sample_axes: tuple[int, ...] = (1, 2),
    per_sample: bool = True,
) -> torch.Tensor:
    """Max-referenced dB: 10·log10(max(x, amin)) − max, floored at
    −dynamic_range. per_sample=False takes one max over the whole batch
    (over every rank's inside ``batch_global_db``)."""
    log_spec = 10.0 * torch.log10(torch.clamp(x, min=amin))
    if per_sample:
        ref = torch.amax(log_spec, dim=sample_axes, keepdim=True)
    else:
        ref = torch.amax(log_spec)
        group = _DB_GROUP.get()
        if group is not None:
            ref = ref.detach().clone()
            dist.all_reduce(ref, op=dist.ReduceOp.MAX, group=group)
    return torch.clamp(log_spec - ref, min=-dynamic_range)


def l3_log_norm(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L3-paper normalization log(max(x, eps)) / 5 (reference audio_model.py:43)."""
    return torch.log(torch.clamp(x, min=eps)) / 5.0


def power_frames(
    x: torch.Tensor,
    n_dft: int,
    hop: int,
    padding: str,
    dtype: torch.dtype,
    n_win: int | None = None,
) -> torch.Tensor:
    """(B, n) → (B, T, n_freq) power spectrum with `dtype` operands and a
    Hann window of n_win samples (default n_dft) centred in the frame."""
    frames = as_operand(frame_signal(x.float(), n_dft, hop, padding), dtype)
    real, imag = stft_basis_f32(n_dft, n_win)
    re = frames @ as_operand(torch.from_numpy(real).to(x.device), dtype)
    im = frames @ as_operand(torch.from_numpy(imag).to(x.device), dtype)
    return re * re + im * im


def to_nhwc_db(m: torch.Tensor, cfg: MelConfig | SpectrogramConfig) -> torch.Tensor:
    """(B, T, F) frames-major → (B, F, T, 1), then dB when cfg.decibel."""
    m = m.transpose(1, 2)[..., None]
    if cfg.decibel:
        m = amplitude_to_db(m, per_sample=cfg.db_per_sample)
    return m


def melspectrogram(x: torch.Tensor, cfg: MelConfig = MelConfig()) -> torch.Tensor:
    """(B, n) → (B, n_mels, T, 1), f32 throughout (the JAX f32
    HIGHEST-precision front end). Needs TF32 off on the card."""
    p = power_frames(x, cfg.n_dft, cfg.hop, cfg.padding, torch.float32)
    m = p @ torch.from_numpy(mel_matrix(cfg)).to(x.device)
    if cfg.power_melgram != 2.0:
        # dB is taken of the *amplitude* melgram when power_melgram is 1.
        m = m ** (cfg.power_melgram / 2.0)
    return to_nhwc_db(m, cfg)


def mel_tail_bf16(p: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """(B, T, n_freq) power frames → (B, n_mels, T, 1): the mel product with
    bf16 operands and f32 accumulation, then power, transpose and dB (the JAX
    package's ``_mel_tail_bf16``, shared by its bf16 and int8-DFT front ends).
    TF32 is kept off on the card."""
    from ..models.towers import ieee_fp32  # towers imports this module

    mel_t = as_operand(torch.from_numpy(mel_matrix(cfg)).to(p.device), torch.bfloat16)
    with ieee_fp32(p.is_cuda):
        m = as_operand(p, torch.bfloat16) @ mel_t
    if cfg.power_melgram != 2.0:
        m = torch.sqrt(torch.clamp(m, min=0.0)) ** cfg.power_melgram
    return to_nhwc_db(m, cfg)


def melspectrogram_bf16(x: torch.Tensor, cfg: MelConfig = MelConfig()) -> torch.Tensor:
    """(B, n) → (B, n_mels, T, 1) with bf16 operands and f32 accumulation
    in both matmuls (the JAX package's fast XLA front end)."""
    return mel_tail_bf16(power_frames(x, cfg.n_dft, cfg.hop, cfg.padding, torch.bfloat16), cfg)


INT_MM_STEP = 8  # torch._int_mm on the card wants K and N multiples of 8


@functools.lru_cache(maxsize=None)
def stft_basis_int8(n_dft: int, n_win: int | None = None, width: int | None = None):
    """The fused per-column symmetric int8 DFT bank and its f32 column
    scales (a copy of the JAX package's ``_stft_basis_int8``): one
    (width, 2·n_freq) int8 matrix, re columns then im columns, column f
    quantized with its own scale c[f] = amax(|col|)/127. Rows past n_dft
    (width defaults to n_dft) are zero."""
    real, imag = dsp_ref.stft_basis(n_dft, n_win)
    bank = np.zeros((width or n_dft, real.shape[1] + imag.shape[1]), np.float32)
    bank[:n_dft] = np.concatenate([real, imag], axis=1)
    c = (np.maximum(np.abs(bank).max(axis=0), 1e-12) / 127.0).astype(np.float32)
    return np.clip(np.round(bank / c), -127, 127).astype(np.int8), c


@functools.lru_cache(maxsize=None)
def int8_bank_device(n_dft: int, device: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(bank^T (N_pad, n_dft) int8, column scales (2·n_freq,) f32) on
    `device`: the bank transposed, its columns zero-padded to a multiple of
    INT_MM_STEP (2·1025 = 2050 → 2056 at n_dft 2048), so that ``bank_t.t()``
    is the column-major right operand torch._int_mm takes."""
    bank, c = stft_basis_int8(n_dft)
    n_pad = -(-bank.shape[1] // INT_MM_STEP) * INT_MM_STEP
    bank_t = np.zeros((n_pad, n_dft), np.int8)
    bank_t[: bank.shape[1]] = bank.T
    return torch.from_numpy(bank_t).to(device), torch.from_numpy(c).to(device)


def quantize_waveform(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, n) f32 → (int8 waveform, (B, 1) f32 scale): one symmetric scale a
    window, s = max(amax|x|, 1e-6)/127, round half to even, clip ±127."""
    s = torch.clamp(x.abs().amax(-1, keepdim=True), min=1e-6) / 127.0
    return torch.clamp(torch.round(x / s), -127, 127).to(torch.int8), s


def int8_dft_product(frames: torch.Tensor, bank_t: torch.Tensor) -> torch.Tensor:
    """(M, n_dft) int8 frames × the int8 bank → (M, N_pad) int32, exact: on
    the card torch._int_mm (s8 × s8 → s32), on the CPU a float64 product,
    whose partial sums are exact integers (|sum| ≤ n_dft·127² < 2⁵³)."""
    if frames.is_cuda:
        return torch._int_mm(frames, bank_t.t())
    return (frames.double() @ bank_t.t().double()).to(torch.int32)


def melspectrogram_int8dft(x: torch.Tensor, cfg: MelConfig = MelConfig()) -> torch.Tensor:
    """(B, n) → (B, n_mels, T, 1) mel features with the DFT stage s8 × s8 →
    s32 (port of the JAX package's ``melspectrogram_int8dft``).

    The waveform is quantized per window (``quantize_waveform``) before it
    is framed, the frames multiply the fused re|im int8 bank, the exact
    dequant s·c folds into the power (|s·c·z|² = s²·(c·z)²), and the mel
    product and dB tail are ``mel_tail_bf16``. The JAX package frames in
    chunks (k·hop = 2178 columns, padded to 2304) against a bank whose rows
    past n_dft are zero; those columns add nothing, so plain n_dft-wide
    frames give the same int32 product.
    """
    xq, s = quantize_waveform(x.float())
    frames = frame_signal(xq, cfg.n_dft, cfg.hop, cfg.padding)
    batch, n_frames = frames.shape[:2]
    bank_t, c = int8_bank_device(cfg.n_dft, str(x.device))
    z = int8_dft_product(frames.reshape(batch * n_frames, cfg.n_dft), bank_t)
    n_freq = cfg.n_dft // 2 + 1
    z = z[:, : 2 * n_freq].float() * c
    re, im = z[:, :n_freq], z[:, n_freq:]
    p = (re * re + im * im).reshape(batch, n_frames, n_freq) * torch.square(s)[..., None]
    return mel_tail_bf16(p, cfg)


def spectrogram(x: torch.Tensor, cfg: SpectrogramConfig = SpectrogramConfig()) -> torch.Tensor:
    """(B, n) → (B, n_freq, T, 1) |STFT|^power, f32 throughout (the JAX f32
    HIGHEST-precision front end); dB, when on, is of that |STFT|^power.
    Needs TF32 off on the card."""
    p = power_frames(x, cfg.n_dft, cfg.hop, cfg.padding, torch.float32, cfg.n_win)
    s = p ** (cfg.power / 2.0) if cfg.power != 2.0 else p
    return to_nhwc_db(s, cfg)


def spectrogram_bf16(x: torch.Tensor, cfg: SpectrogramConfig = SpectrogramConfig()) -> torch.Tensor:
    """(B, n) → (B, n_freq, T, 1) |STFT|^power with bf16 operands and f32
    accumulation (the JAX package's fast XLA front end)."""
    p = power_frames(x, cfg.n_dft, cfg.hop, cfg.padding, torch.bfloat16, cfg.n_win)
    s = p ** (cfg.power / 2.0) if cfg.power != 2.0 else p
    return to_nhwc_db(s, cfg)
