"""Audio-Visual Correspondence model (port of ``l3embedding_tpu/models/avc.py``).

concat(vision, audio) → Dense(layer_size) → ReLU → Dense(2), returning f32
logits; ``predict_proba`` is the softmax over them (the reference's
``model.predict()``). Submodule names mirror flax's (``vision_model``,
``audio_model``, ``merge_dense``, ``output_dense``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .towers import HeInit, _CopyToModel, _ReduceFromModel, ieee_fp32, model_split


def _dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x @ Wᵀ + b in `dtype`. A row-split layer (``parallel/tp.py``) takes
    its block of the replicated input's columns (whose gradient
    ``_CopyToModel`` sums over the model group), sums the partial products
    over the group in f32 and adds the bias once."""
    split = model_split(layer)
    if split is None:
        return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))
    k = layer.weight.shape[1]
    x = _CopyToModel.apply(x, split.group)[:, split.index * k:(split.index + 1) * k]
    y = _ReduceFromModel.apply(F.linear(x.to(dtype), layer.weight.to(dtype)).float(), split.group)
    return (y + layer.bias.float()).to(dtype)


class AVCModel(HeInit):
    """vision_model + audio_model + correspondence head.

    video: (B, 224, 224, 3) NHWC in [-1, 1]; audio: (B, 1, 48000) or
    (B, 48000) PCM. The dense layers run in `dtype` with f32 parameters;
    the logits are f32.
    """

    def __init__(self, vision_model: nn.Module, audio_model: nn.Module,
                 layer_size: int = 128, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.vision_model = vision_model
        self.audio_model = audio_model
        self.dtype = dtype
        self.merge_dense = nn.Linear(vision_model.out_dim + audio_model.out_dim, layer_size)
        self.output_dense = nn.Linear(layer_size, 2)

    def forward(self, video: torch.Tensor, audio: torch.Tensor, train: bool = False) -> torch.Tensor:
        """→ (B, 2) f32 logits. train=True runs the towers' BatchNorms in
        train mode (batch statistics, running statistics updated)."""
        # Keras concat order: vision output first.
        y = torch.cat([self.vision_model(video, train), self.audio_model(audio, train)], dim=-1)
        with ieee_fp32(y.is_cuda and self.dtype == torch.float32):
            y = torch.relu(_dense(self.merge_dense, y, self.dtype))
            return _dense(self.output_dense, y, self.dtype).float()

    @torch.no_grad()
    def predict_proba(self, video: torch.Tensor, audio: torch.Tensor) -> torch.Tensor:
        """Correspondence probabilities: softmax over the 2-way head."""
        return torch.softmax(self(video, audio), dim=-1)
