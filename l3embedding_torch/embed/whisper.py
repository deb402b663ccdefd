"""Whisper encoder embeddings through the port's extractor.

``WhisperExtractor`` is an ``EmbeddingExtractor`` whose model is
Whisper's log-mel front end (``ops/frontend.whisper_log_mel``) and audio
encoder (``models/whisper_encoder.py``): one 30 s window of 16 kHz PCM
(480,000 samples) → its (1500, 1280) frame rows, 20 ms a frame. It keeps
the extractor's pinned staging, stream, uploads, buckets, ``EmbeddingRows``
and ``extract.*`` spans. A clip is cut into non-overlapping 30 s windows,
the last zero-padded (``frame_whisper``; a clip under 30 s is one window),
and ``embed_windows_async`` takes windows of any number of clips in one
call. While tracing is on, each ``extract.call`` counts its ``windows``
and their ``pad_samples``, the zero samples that pad clips out to whole
windows.
"""

from __future__ import annotations

import logging

import numpy as np
import torch
import torch.nn as nn

from ..models.towers import ieee_fp32
from ..models.whisper_encoder import (
    LARGE_V3,
    WhisperDims,
    build_encoder,
    load_whisper_state_dict,
    read_state_dict,
)
from ..ops.frontend import WHISPER_HOP, WHISPER_N_SAMPLES, WHISPER_SR, whisper_log_mel
from ..utils import trace
from .extract import INIT_SEED, EmbeddingExtractor, EmbeddingRows, _bucket

LOGGER = logging.getLogger("l3embedding_torch.whisper")

MODEL_TYPE = "whisper_large_v3"
# A 30 s window is ~110 L3 windows of work, so a batch is padded to at
# most twice its windows, not to the L3 extractor's 16-row floor.
BUCKETS = (1, 2, 4, 8, 16, 32)


def frame_whisper(audio: np.ndarray, window: int = WHISPER_N_SAMPLES) -> tuple[np.ndarray, int]:
    """A clip → ((n, window) float32 non-overlapping windows, the zero
    samples that pad its last window); a clip under one window (or empty)
    is one window."""
    audio = np.asarray(audio, dtype=np.float32).reshape(-1)
    n = max(1, -(-len(audio) // window))
    out = np.zeros((n, window), np.float32)
    out.reshape(-1)[: len(audio)] = audio
    return out, n * window - len(audio)


class WhisperEmbedding(nn.Module):
    """(B, 1, 480000) or (B, 480000) PCM → (B, 1500, 1280) float32 frame
    rows: the front end in float32 (TF32 off on the card; an
    ``encoder.frontend`` span), then the encoder in its compute dtype (with
    TF32 off too when that is float32)."""

    def __init__(self, encoder: nn.Module):
        super().__init__()
        self.encoder = encoder

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 3:
            x = x[:, 0, :]
        with trace.span("encoder.frontend"):
            mel = whisper_log_mel(x, self.encoder.dims.n_mels)
        with ieee_fp32(x.is_cuda and self.encoder.dtype == torch.float32):
            return self.encoder(mel).float()


class WhisperExtractor(EmbeddingExtractor):
    """A resident Whisper encoder on `device` behind the extractor's path.

    weights: a path (Whisper's ``.pt``, a torch state dict, ``.safetensors``)
    or a state dict, in Whisper's or Hugging Face's names; None runs the
    seeded random init (``WhisperEncoder.reset_parameters``, generator
    seeded with INIT_SEED) and says so. fast=True computes the encoder in
    bf16 (the front end stays float32); False is the float32 configuration.
    dims: the encoder's sizes (large-v3's by default)."""

    # A call's rows are 7.7 MB a window: ``result()`` hands out the pinned
    # buffer itself, since a copy of 32 windows' rows costs the host about
    # as long as the card takes for the call.
    copy_rows = False
    # The rows' copy back (246 MB a call of 32) overlaps the next call's
    # forward, so that the card's compute does not wait on the host link.
    side_download = True

    def __init__(self, weights=None, fast: bool = True, device: str | torch.device = "cuda",
                 dims: WhisperDims = LARGE_V3):
        device = torch.device(device)
        encoder = build_encoder(dims, torch.bfloat16 if fast else torch.float32, device)
        if weights is None:
            encoder.reset_parameters(torch.Generator().manual_seed(INIT_SEED))
            LOGGER.warning("Whisper encoder weights not given — running with a random init (seed %d)", INIT_SEED)
        else:
            load_whisper_state_dict(encoder, read_state_dict(weights) if isinstance(weights, str) else weights)
        model = WhisperEmbedding(encoder).eval()
        self._bind([model], [device], None, MODEL_TYPE, "frames", WHISPER_SR, False)
        self.window = 2 * dims.n_audio_ctx * WHISPER_HOP  # samples a window: 2 mel frames a row

    def _bucket_size(self, n: int) -> int:
        return _bucket(n, BUCKETS)

    def embed_windows_async(self, windows, pad_samples: int = 0) -> EmbeddingRows:
        """Dispatch (N, 480000) windows, of one clip or several, without
        synchronising; ``result()`` gives their (N, 1500, 1280) rows.
        `pad_samples`: how many of the windows' samples are zeros padding
        clips out to whole windows (a counter while tracing is on)."""
        with trace.span("extract.call", self._streams[0]):
            trace.count("extract.call", windows=len(windows), pad_samples=int(pad_samples))
            return super().embed_windows_async(windows)

    def embed_audio_async(self, audio: np.ndarray, hop_size: float | None = None,
                          device_framing: bool | None = None) -> EmbeddingRows:
        """A 16 kHz mono clip → its windows' rows, (n, 1500, 1280), without
        the sync. The windows do not overlap, so `hop_size` and
        `device_framing` (kept for the extractor's signature) are unused."""
        with trace.span("extract.call", self._streams[0]):
            with trace.span("extract.upload"):
                windows, pad = frame_whisper(audio, self.window)
            return self.embed_windows_async(windows, pad)
