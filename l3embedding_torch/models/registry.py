"""Model registry of the port: the five AVC model types of the reference
(port of ``l3embedding_tpu/models/registry.py``).

``build_model(model_type)`` returns a ModelSpec that builds the audio
tower, the vision tower or the whole AVC model, and carries the audio
embedding pooling table.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from .avc import AVCModel
from .towers import L3AudioTower, L3VisionTower, TinyL3AudioTower, TinyL3VisionTower

AUDIO_INPUT_SHAPE = (1, 48000)  # (channels, samples), as the reference feeds it
VIDEO_INPUT_SHAPE = (224, 224, 3)
_FULL_POOL_257 = {"original": (8, 8), "short": (32, 24)}
_FULL_POOL_128 = {"original": (4, 8), "short": (16, 24)}


@dataclass(frozen=True)
class ModelSpec:
    """A model type: its towers' shapes and its embedding poolings.

    audio_frontend is the L3AudioTower front end ('linear', 'linear_db',
    'mel'), or 'tiny' for the miniature towers, which are always f32 (the
    JAX package's tiny_L3 ignores compute_dtype)."""

    name: str
    audio_frontend: str
    n_mels: int = 128
    final_pool: tuple = (32, 24)
    vision_input_bn: bool = True
    layer_size: int = 128
    audio_input_shape: tuple = AUDIO_INPUT_SHAPE
    video_input_shape: tuple = VIDEO_INPUT_SHAPE
    # SAME max-pool sizes over the raw embedding-conv output, per pooling
    # type (reference audio_model.py:461-478).
    audio_embedding_pooling: dict = field(default_factory=dict)

    @property
    def tiny(self) -> bool:
        return self.audio_frontend == "tiny"

    def audio_tower(
        self, compute_dtype: torch.dtype = torch.float32, db_batch_global: bool = False
    ):
        """A fresh (uninitialised) audio tower; compute_dtype float32 is
        the parity configuration, bfloat16 the fast one."""
        if self.tiny:
            return TinyL3AudioTower(db_batch_global=db_batch_global)
        return L3AudioTower(
            frontend_kind=self.audio_frontend,
            n_mels=self.n_mels,
            final_pool=self.final_pool,
            dtype=compute_dtype,
            db_batch_global=db_batch_global,
        )

    def vision_tower(self, compute_dtype: torch.dtype = torch.float32):
        """A fresh (uninitialised) vision tower."""
        if self.tiny:
            return TinyL3VisionTower()
        return L3VisionTower(input_bn=self.vision_input_bn, dtype=compute_dtype)

    def module(
        self, compute_dtype: torch.dtype = torch.float32, db_batch_global: bool = False
    ) -> AVCModel:
        """A fresh (uninitialised) AVC model."""
        if self.tiny:
            compute_dtype = torch.float32
        return AVCModel(
            self.vision_tower(compute_dtype),
            self.audio_tower(compute_dtype, db_batch_global),
            layer_size=self.layer_size,
            dtype=compute_dtype,
        )


MODELS: dict[str, ModelSpec] = {
    "cnn_L3_orig": ModelSpec(
        name="cnn_L3_orig", audio_frontend="linear", vision_input_bn=False,
        audio_embedding_pooling=_FULL_POOL_257,
    ),
    "cnn_L3_kapredbinputbn": ModelSpec(
        name="cnn_L3_kapredbinputbn", audio_frontend="linear_db",
        audio_embedding_pooling=_FULL_POOL_257,
    ),
    "cnn_L3_melspec1": ModelSpec(
        name="cnn_L3_melspec1", audio_frontend="mel", n_mels=128, final_pool=(16, 24),
        audio_embedding_pooling=_FULL_POOL_128,
    ),
    "cnn_L3_melspec2": ModelSpec(
        name="cnn_L3_melspec2", audio_frontend="mel", n_mels=256,
        audio_embedding_pooling=_FULL_POOL_257,
    ),
    "tiny_L3": ModelSpec(
        name="tiny_L3", audio_frontend="tiny", layer_size=64,
        # Tiny embedding = the flattened final feature map itself.
        audio_embedding_pooling={"original": (1, 1), "short": (1, 1)},
    ),
}


def build_model(model_type: str) -> ModelSpec:
    if model_type not in MODELS:
        raise ValueError(
            f'Invalid model type: "{model_type}" (have: {sorted(MODELS)})'
        )
    return MODELS[model_type]
