"""Embedding extraction (port of ``l3embedding_tpu/models/embedding.py``).

The embedding is the raw ``{audio,vision}_embedding_layer`` conv output
(the tiny towers: their last pooled map), max-pooled with SAME padding
(reference audio_model.py:483, vision_model.py:213) and flattened in NHWC
order. Dims: audio 'original' → 6144, 'short' → 512 (tiny: 350); vision
→ 8192.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .registry import MODELS, build_model
from .towers import nhwc_flatten, same_max_pool

AUDIO_POOLINGS = {name: spec.audio_embedding_pooling for name, spec in MODELS.items()}
VISION_POOLING = (7, 7)  # reference vision_model.py:212


def _pool_flatten(feat: torch.Tensor, pool: tuple[int, int]) -> torch.Tensor:
    """(B, H, W, C) NHWC → SAME max-pool (window = stride = pool) → (B, -1)
    flattened in NHWC order."""
    return nhwc_flatten(same_max_pool(feat.permute(0, 3, 1, 2), pool))


class Embedding(nn.Module):
    """A tower's input (PCM (B, 1, n) or (B, n); images (B, 224, 224, 3))
    → (B, dim) embeddings."""

    def __init__(self, tower: nn.Module, pool: tuple[int, int]):
        super().__init__()
        self.tower = tower
        self.pool = tuple(pool)

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _pool_flatten(self.tower.features(x), self.pool)


def audio_embedding_fn(
    model_type: str,
    pooling_type: str = "original",
    compute_dtype: torch.dtype = torch.float32,
    db_batch_global: bool = False,
) -> Embedding:
    """The audio embedding function for one (model_type, pooling) as a module.

    Its weights are the audio tower's: load them with
    ``fn.tower.load_state_dict(...)`` (e.g. from
    ``compat.from_jax.from_jax_variables``) or
    ``fn.tower.reset_parameters(generator)``. compute_dtype bfloat16 is
    the fast tower; db_batch_global reproduces kapre<=0.1.x's
    batch-global dB quirk.
    """
    spec = build_model(model_type)
    pool = spec.audio_embedding_pooling[pooling_type]
    return Embedding(spec.audio_tower(compute_dtype, db_batch_global), pool)


def vision_embedding_fn(model_type: str) -> Embedding:
    """The 8192-d vision embedding function (f32, as in the JAX package);
    its weights are the vision tower's (``compat.from_jax.vision_from_jax_variables``)."""
    return Embedding(build_model(model_type).vision_tower(), VISION_POOLING)
