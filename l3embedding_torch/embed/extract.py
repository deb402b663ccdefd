"""Windowed embedding extraction (port of ``l3embedding_tpu/embed/extract.py``).

Files are framed on the host into overlapping 1 s windows with the
reference's centering/padding math, and window batches are zero-padded
up to a power-of-two bucket, as in the JAX package, so a batch's rows do
not depend on how many real windows share it, even under the
batch-global dB quirk (zero rows sit at the −100 dB amin floor).
"""

from __future__ import annotations

import numpy as np
import torch

from ..compat.from_jax import from_jax_variables
from ..models.embedding import audio_embedding_fn
from ..training.checkpoints import load_variables

BUCKETS = (16, 32, 64, 128, 256, 512)
INIT_SEED = 0


def frame_uniform(audio: np.ndarray, sr: int = 48000, hop_size: float = 0.1):
    """Overlapping 1 s windows with the reference's centering/padding
    (reference features.py:256-301) → (num_windows, frame_length) f32."""
    hop_length = int(hop_size * sr)
    frame_length = sr * 1

    audio_length = len(audio)
    if audio_length < frame_length:
        pad_length = frame_length - audio_length
    else:
        # Reference quirk kept on purpose (features.py:288): the ceil is
        # applied to the *difference*, a no-op on an integer, so a
        # non-hop-aligned clip loses its trailing partial window. Row
        # counts then align file for file with reference feature sets.
        pad_length = (
            int(np.ceil(audio_length - frame_length) / hop_length) * hop_length
            - (audio_length - frame_length)
        )
    if pad_length > 0:
        left = pad_length // 2
        audio = np.pad(audio, (left, pad_length - left), mode="constant")

    n = (len(audio) - frame_length) // hop_length + 1
    strides = (audio.strides[0] * hop_length, audio.strides[0])
    return np.lib.stride_tricks.as_strided(
        audio, shape=(n, frame_length), strides=strides
    ).astype(np.float32)


def _bucket(n: int) -> int:
    for b in BUCKETS:
        if n <= b:
            return b
    return int(np.ceil(n / BUCKETS[-1])) * BUCKETS[-1]


class EmbeddingExtractor:
    """Batched audio-embedding extractor for one (model_type, pooling) of
    any of the five model types, holding the tower's weights resident on
    `device`.

    weights_path: a ``.ckpt`` written by the JAX package
    (``training/checkpoints.save_variables``), or None for a random model:
    He-normal conv kernels drawn from a ``torch.Generator`` seeded with
    INIT_SEED. That init is reproducible but is not flax's: the numbers
    differ from the JAX extractor's random init.
    fast=True runs the bf16 tower (bf16 kernel front end and convs;
    tiny_L3 stays f32, as in the JAX package); False keeps the f32 parity
    configuration.
    db_batch_global=True reproduces kapre<=0.1.x's batch-global dB quirk.
    """

    def __init__(
        self,
        weights_path: str | None,
        model_type: str,
        pooling_type: str = "original",
        sr: int = 48000,
        fast: bool = False,
        db_batch_global: bool = False,
        device: str | torch.device = "cuda",
    ):
        self.model_type = model_type
        self.pooling_type = pooling_type
        self.sr = sr
        self.device = torch.device(device)
        model = audio_embedding_fn(
            model_type,
            pooling_type,
            compute_dtype=torch.bfloat16 if fast else torch.float32,
            db_batch_global=db_batch_global,
        )
        if weights_path is None:
            model.tower.reset_parameters(torch.Generator().manual_seed(INIT_SEED))
        else:
            model.tower.load_state_dict(
                from_jax_variables(load_variables(weights_path), model_type)
            )
        self.model = model.eval().to(self.device)

    def embed_windows_async(self, windows) -> torch.Tensor:
        """Dispatch (N, frame_length) windows without synchronizing;
        returns the (N, dim) rows as a tensor on the device."""
        n = windows.shape[0]
        x = torch.as_tensor(windows, dtype=torch.float32)
        bucket = _bucket(n)
        if bucket != n:
            x = torch.cat([x, x.new_zeros((bucket - n, x.shape[1]))])
        x = x.to(self.device)[:, None, :]  # (B, 1, 48000) reference input convention
        return self.model(x)[:n]

    def embed_windows(self, windows) -> np.ndarray:
        """(N, frame_length) float32 → (N, dim) embeddings."""
        return self.embed_windows_async(windows).cpu().numpy()

    def embed_audio(self, audio: np.ndarray, hop_size: float = 0.1) -> np.ndarray:
        """A mono clip at self.sr → one embedding row per window."""
        return self.embed_windows(frame_uniform(audio, self.sr, hop_size))
