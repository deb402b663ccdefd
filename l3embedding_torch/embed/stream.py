"""Streaming (incremental) embedding extraction (host-only port of
``l3embedding_tpu/embed/stream.py``).

Real-time audio tagging needs the file path's rows computed incrementally
as PCM arrives. `StreamingEmbedder` wraps any resident extractor that
exposes ``sr`` and ``embed_windows`` and reproduces the file path's
framing exactly: feeding a finite stream chunk by chunk and flushing
yields the same embedding rows as ``embed_audio`` on the whole buffer.

Framing contract mirrored from extract.frame_uniform (which reproduces
reference features.py:256-301, quirks included):

  * streams >= one window (1 s): windows start at 0, hop, 2*hop, ...;
    a trailing partial window is dropped.
  * streams < one window: one window, the audio centered in zeros,
    emitted by flush(), since only end-of-stream proves it stays short.

Each feed() makes at most one extractor call, batching every window the
chunk completed. For many concurrent streams, pass an adapter that
exposes the micro-batching EmbeddingService's blocking submit as
embed_windows (as embed/http_serve.py does).
"""

from __future__ import annotations

import numpy as np

from ..data.audio_io import pcm2float


class StreamingEmbedder:
    """Incremental embeddings over a PCM stream, one stream per instance.

    feed(samples) -> (k, dim) rows for windows the chunk completed
    (k may be 0); flush() -> final rows (the centered short-stream
    window, if any) and seals the stream. Accepts float PCM in [-1, 1]
    or integer PCM (converted like the training pipeline's pcm2float,
    reference l3embedding/audio.py:1-31).
    """

    def __init__(self, extractor, hop_size: float = 0.1):
        self.extractor = extractor
        self.sr = int(extractor.sr)
        self.frame_length = self.sr  # 1 s windows: the L3 input contract
        self.hop_length = int(hop_size * self.sr)
        if self.hop_length <= 0:
            raise ValueError(f"hop_size {hop_size} yields a non-positive "
                             f"hop at sr={self.sr}")
        self._buf = np.zeros(0, np.float32)
        self._total = 0        # samples ever fed
        self._consumed = 0     # samples dropped off the buffer's left
        self._next_offset = 0  # absolute start of the next window
        self._dim = 0          # embedding dim, known after the first emit
        self._flushed = False
        self.windows_emitted = 0

    def _empty(self) -> np.ndarray:
        return np.zeros((0, self._dim), np.float32)

    def _embed(self, windows: list[np.ndarray]) -> np.ndarray:
        out = np.asarray(
            self.extractor.embed_windows(np.stack(windows)), np.float32
        )
        self._dim = out.shape[1]
        self.windows_emitted += out.shape[0]
        return out

    def feed(self, samples: np.ndarray) -> np.ndarray:
        """Append PCM; return embeddings for every window it completed."""
        if self._flushed:
            raise RuntimeError("feed() after flush(); streams are one-shot")
        x = np.asarray(samples)
        if x.ndim != 1:
            raise ValueError(f"expected mono 1-D PCM, got shape {x.shape}")
        if np.issubdtype(x.dtype, np.integer):
            x = pcm2float(x)
        self._buf = np.concatenate([self._buf, x.astype(np.float32)])
        self._total += len(x)

        windows = []
        while self._next_offset + self.frame_length <= self._total:
            start = self._next_offset - self._consumed
            windows.append(self._buf[start:start + self.frame_length].copy())
            self._next_offset += self.hop_length
        # Drop samples no window can need again (bounds memory at
        # ~1 s regardless of stream length). When hop > window the next
        # offset can point past everything fed so far; only samples that
        # actually exist can be dropped, else _consumed desyncs from the
        # buffer and later windows start at the wrong sample.
        drop = min(self._next_offset, self._total) - self._consumed
        if drop > 0:
            self._buf = self._buf[drop:]
            self._consumed += drop
        if not windows:
            return self._empty()
        return self._embed(windows)

    def flush(self) -> np.ndarray:
        """Seal the stream; return any final rows.

        A stream shorter than one window yields its single centered
        zero-padded window here (matching frame_uniform on the same
        buffer — including the empty stream, which the reference
        framing maps to one all-zeros window). Longer streams return
        no rows: every complete window was already emitted by feed(),
        and the reference framing drops partial tails.
        """
        if self._flushed:
            return self._empty()
        self._flushed = True
        if self._total >= self.frame_length:
            return self._empty()
        pad = self.frame_length - self._total
        left = pad // 2
        window = np.pad(self._buf, (left, pad - left), mode="constant")
        return self._embed([window])
