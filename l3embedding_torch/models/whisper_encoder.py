"""Whisper's audio encoder (openai/whisper, ``whisper/model.py``:
``AudioEncoder``, ``ResidualAttentionBlock``, ``MultiHeadAttention``,
``sinusoids``), at large-v3's sizes by default.

    mel (B, n_mels, 2·n_ctx) → GELU(conv1) → GELU(conv2, stride 2)
      → + sinusoids(n_ctx, n_state) → n_layer × [x += attn(LN(x));
      x += mlp(LN(x))] → ln_post → (B, n_ctx, n_state)

conv1 is n_mels → n_state, kernel 3, padding 1; conv2 n_state → n_state,
kernel 3, stride 2, padding 1. Attention has n_head heads of n_state /
n_head, biases on query, value and out and none on key, no mask, and the
scale 1/√head, which equals Whisper's head^-¼ on q and on k. The MLP is
n_state → 4·n_state → n_state with exact-erf GELU. Each LayerNorm (ε 1e-5)
takes its input in float32 and returns the compute dtype, and the
attention's softmax runs in float32 (``F.scaled_dot_product_attention``),
as Whisper's ``LayerNorm`` and ``softmax(..., dtype=float32)`` do.

The module's names are Whisper's own, so a Whisper state dict loads as it
is (``load_whisper_state_dict`` also takes Hugging Face's
``WhisperEncoder`` names). ``cast_(torch.bfloat16)`` stores the convs' and
linears' weights in bf16, the compute dtype; the LayerNorms and the
positional table stay float32.

Spans while tracing is on (``utils/trace.py``): ``encoder.stem`` (the
convs and the positional table) and ``encoder.attn`` around each attention
core, timed on the device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils import trace

LN_EPS = 1e-5


@dataclass(frozen=True)
class WhisperDims:
    """The encoder's sizes (Whisper's ``ModelDimensions``, audio half)."""

    n_mels: int = 128
    n_audio_ctx: int = 1500
    n_audio_state: int = 1280
    n_audio_head: int = 20
    n_audio_layer: int = 32

    @property
    def n_mlp(self) -> int:
        return 4 * self.n_audio_state


LARGE_V3 = WhisperDims()


def sinusoids(length: int, channels: int, max_timescale: float = 10000.0) -> torch.Tensor:
    """(length, channels) float32: [sin | cos] of t at the timescales
    exp(−log(max_timescale) / (channels/2 − 1) · i), as Whisper's."""
    log_timescale_increment = np.log(max_timescale) / (channels // 2 - 1)
    inv_timescales = torch.exp(-log_timescale_increment * torch.arange(channels // 2))
    scaled_time = torch.arange(length)[:, None] * inv_timescales[None, :]
    return torch.cat([torch.sin(scaled_time), torch.cos(scaled_time)], dim=1)


class LayerNorm(nn.LayerNorm):
    """LayerNorm of the float32 input, returned in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float()).type(x.dtype)


class Linear(nn.Linear):
    """A linear layer in its input's dtype (a no-op cast once ``cast_`` has
    stored the weight in that dtype)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class Conv1d(nn.Conv1d):
    def _conv_forward(self, x, weight, bias):
        return super()._conv_forward(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype))


class MultiHeadAttention(nn.Module):
    def __init__(self, n_state: int, n_head: int):
        super().__init__()
        self.n_head = n_head
        self.query = Linear(n_state, n_state)
        self.key = Linear(n_state, n_state, bias=False)
        self.value = Linear(n_state, n_state)
        self.out = Linear(n_state, n_state)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        heads = lambda y: y.view(b, t, self.n_head, d // self.n_head).transpose(1, 2)  # noqa: E731
        q, k, v = heads(self.query(x)), heads(self.key(x)), heads(self.value(x))
        with trace.span("encoder.attn", x.device):
            o = F.scaled_dot_product_attention(q, k, v)
        return self.out(o.transpose(1, 2).reshape(b, t, d))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, n_state: int, n_head: int):
        super().__init__()
        self.attn = MultiHeadAttention(n_state, n_head)
        self.attn_ln = LayerNorm(n_state, eps=LN_EPS)
        self.mlp = nn.Sequential(Linear(n_state, 4 * n_state), nn.GELU(), Linear(4 * n_state, n_state))
        self.mlp_ln = LayerNorm(n_state, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.attn_ln(x))
        return x + self.mlp(self.mlp_ln(x))


class WhisperEncoder(nn.Module):
    """Whisper's audio encoder: (B, n_mels, 2·n_ctx) log-mel → (B, n_ctx,
    n_state) in the compute dtype (float32 until ``cast_``)."""

    def __init__(self, dims: WhisperDims = LARGE_V3):
        super().__init__()
        self.dims = dims
        d = dims.n_audio_state
        self.conv1 = Conv1d(dims.n_mels, d, kernel_size=3, padding=1)
        self.conv2 = Conv1d(d, d, kernel_size=3, stride=2, padding=1)
        self.register_buffer("positional_embedding", sinusoids(dims.n_audio_ctx, d))
        self.blocks = nn.ModuleList(ResidualAttentionBlock(d, dims.n_audio_head) for _ in range(dims.n_audio_layer))
        self.ln_post = LayerNorm(d, eps=LN_EPS)
        self.dtype = torch.float32

    def cast_(self, dtype: torch.dtype) -> WhisperEncoder:
        """Store the convs' and linears' parameters in `dtype`, which becomes
        the compute dtype; LayerNorms and the positional table keep float32."""
        for m in self.modules():
            if isinstance(m, (Linear, Conv1d)):
                m.to(dtype)
        self.dtype = dtype
        return self

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        with trace.span("encoder.stem"):
            x = F.gelu(self.conv1(mel.to(self.dtype)))
            # Positions-major and contiguous: a permuted view here would
            # leave every later add, cast and LayerNorm strided.
            x = F.gelu(self.conv2(x)).permute(0, 2, 1).contiguous()
            x = (x + self.positional_embedding).to(x.dtype)
        for block in self.blocks:
            x = block(x)
        return self.ln_post(x)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """A seeded init from `generator` (drawn on the CPU, in module order):
        linear weights N(0, 0.02), conv weights He-normal (fan in
        channels·3), every bias N(0, 0.02), LayerNorm scales 1 + 0.1·N and
        offsets 0.1·N; the positional table is the sinusoids."""
        for name, p in self.named_parameters():
            z = torch.randn(p.shape, generator=generator)
            if name.endswith("bias"):
                z = z * (0.1 if _is_layer_norm(self, name) else 0.02)
            elif _is_layer_norm(self, name):
                z = 1.0 + 0.1 * z
            elif p.dim() == 3:
                z = z * math.sqrt(2.0 / (p.shape[1] * p.shape[2]))
            else:
                z = z * 0.02
            p.copy_(z)
        self.positional_embedding.copy_(sinusoids(self.dims.n_audio_ctx, self.dims.n_audio_state))


def _is_layer_norm(module: nn.Module, name: str) -> bool:
    return isinstance(module.get_submodule(name.rsplit(".", 1)[0]), nn.LayerNorm)


def build_encoder(dims: WhisperDims = LARGE_V3, dtype: torch.dtype = torch.float32,
                  device: str | torch.device = "cpu") -> WhisperEncoder:
    """An uninitialised encoder on `device` with its convs and linears in
    `dtype`, made without the default init's draws (built on the meta
    device, then given storage): fill it with ``reset_parameters`` or
    ``load_whisper_state_dict``."""
    with torch.device("meta"):
        enc = WhisperEncoder(dims)
    enc = enc.to_empty(device=device).cast_(dtype)
    enc.positional_embedding.copy_(sinusoids(dims.n_audio_ctx, dims.n_audio_state))
    return enc


# Hugging Face WhisperEncoder names → Whisper's, per layer and at the top.
_HF_LAYER = {
    "self_attn.q_proj": "attn.query", "self_attn.k_proj": "attn.key", "self_attn.v_proj": "attn.value",
    "self_attn.out_proj": "attn.out", "self_attn_layer_norm": "attn_ln", "fc1": "mlp.0", "fc2": "mlp.2",
    "final_layer_norm": "mlp_ln",
}
_HF_TOP = {"embed_positions.weight": "positional_embedding", "layer_norm": "ln_post"}
_PREFIXES = ("model.encoder.", "encoder.")


def whisper_names(state_dict: dict) -> dict:
    """A state dict of the encoder in Whisper's names (``blocks.N.attn.query.weight``,
    bare or under ``encoder.``, as a whole Whisper checkpoint holds it) or
    in Hugging Face's (``layers.N.self_attn.q_proj.weight``, bare or under
    ``encoder.`` / ``model.encoder.``) → the same tensors under Whisper's
    bare names. Keys of other parts (the decoder) are left out."""
    keys = list(state_dict)
    prefix = next((p for p in _PREFIXES if any(k.startswith(p) for k in keys)), "")
    out = {}
    for key, value in state_dict.items():
        if not key.startswith(prefix):
            continue
        name = key[len(prefix):]
        if name.startswith("layers."):
            _, i, rest = name.split(".", 2)
            layer, leaf = rest.rsplit(".", 1)
            name = f"blocks.{i}.{_HF_LAYER.get(layer, layer)}.{leaf}"
        else:
            for hf, ours in _HF_TOP.items():
                if name == hf or name.startswith(hf + "."):
                    name = ours + name[len(hf):]
        out[name] = value
    return out


@torch.no_grad()
def load_whisper_state_dict(model: WhisperEncoder, state_dict: dict) -> WhisperEncoder:
    """Copy an encoder state dict in Whisper's or Hugging Face's names
    (``whisper_names``) into `model` in place, each tensor cast to its
    parameter's dtype; → model. The positional table may be absent (it is
    the fixed sinusoids); any other missing tensor, an unknown one or one
    of another shape raises."""
    given = whisper_names(state_dict)
    own = model.state_dict()
    unknown = sorted(set(given) - set(own))
    missing = sorted(set(own) - set(given) - {"positional_embedding"})
    if unknown or missing:
        raise ValueError(f"not a Whisper encoder state dict: unknown {unknown[:5]}, missing {missing[:5]}")
    for name, value in given.items():
        value = torch.as_tensor(value)
        if tuple(value.shape) != tuple(own[name].shape):
            raise ValueError(f"shape mismatch for {name}: {tuple(value.shape)} vs {tuple(own[name].shape)}")
        own[name].copy_(value)
    if "positional_embedding" not in given:
        own["positional_embedding"].copy_(sinusoids(*own["positional_embedding"].shape))
    return model


def read_state_dict(path: str) -> dict:
    """The tensors of a checkpoint file: Whisper's ``.pt`` (its
    ``model_state_dict``), a torch state dict, or a ``.safetensors`` file
    (needs the safetensors package)."""
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        return load_file(path)
    data = torch.load(path, map_location="cpu", weights_only=True)
    return data.get("model_state_dict", data)
