"""Plain PyTorch reference of Whisper's log-mel front end and audio
encoder (openai/whisper: ``whisper/audio.py::log_mel_spectrogram``,
``whisper/model.py::AudioEncoder``), the benchmark's copy of the one the
program's tests hold it against. It imports nothing of the program; the
weights are the harness's (``make_weights``), made from the seed on the
device, and the filters are worked out here from ``dsp.py``.

* Front end: reflect padding of n_fft/2 on each side, n_fft-sample frames
  at the hop under the periodic Hann window, the one-sided DFT, |X|² with
  the last frame dropped, Slaney-scale mel filters with Slaney's norm,
  log10(max(m, 1e-10)), clamped below at each window's max − 8, (x + 4) / 4.
* Encoder, on the leaves under Whisper's state-dict names: GELU(conv1),
  GELU(conv2, stride 2), + the sinusoids, per block x += out(attention(LN(x)))
  and x += fc2(GELU(fc1(LN(x)))), then ln_post. Attention: q and k each
  scaled by head^-¼, softmax over keys, no mask; LayerNorm ε 1e-5.

``prec``: "f32" (IEEE float32, TF32 off: the reference) or "fp8" (the
control: each linear's two operands rounded to float8 e4m3 under one scale
a tensor, float32 accumulation; the rest float32). Departure from
openai/whisper: the clamp's max is per window, where Whisper's is over its
whole input (one window in its own use).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..generate import torch_generator
from . import dsp
from .model import e4m3, precision

def param_specs(cfg: dict) -> list[tuple]:
    """(name, shape) of every leaf, in Whisper's names and order."""
    d, m, f = cfg["n_audio_state"], cfg["n_mels"], cfg["n_mlp"]
    specs = [("conv1.weight", (d, m, 3)), ("conv1.bias", (d,)), ("conv2.weight", (d, d, 3)), ("conv2.bias", (d,))]
    for i in range(cfg["n_audio_layer"]):
        b = f"blocks.{i}."
        specs += [(b + "attn.query.weight", (d, d)), (b + "attn.query.bias", (d,)), (b + "attn.key.weight", (d, d)),
                  (b + "attn.value.weight", (d, d)), (b + "attn.value.bias", (d,)),
                  (b + "attn.out.weight", (d, d)), (b + "attn.out.bias", (d,)),
                  (b + "attn_ln.weight", (d,)), (b + "attn_ln.bias", (d,)),
                  (b + "mlp.0.weight", (f, d)), (b + "mlp.0.bias", (f,)),
                  (b + "mlp.2.weight", (d, f)), (b + "mlp.2.bias", (d,)),
                  (b + "mlp_ln.weight", (d,)), (b + "mlp_ln.bias", (d,))]
    return specs + [("ln_post.weight", (d,)), ("ln_post.bias", (d,))]


def _is_ln(name: str) -> bool:
    return "_ln." in name or name.startswith("ln_post.")


def make_weights(cfg: dict, seed: int, device: str) -> dict[str, torch.Tensor]:
    """{name: float32 tensor on `device`}: one ``torch.randn`` over every leaf
    with a generator on the device, each slice scaled to its kind: linear
    weights N(0, 0.02), conv weights He-normal (fan in channels · 3),
    biases N(0, 0.02), LayerNorm scales 1 + 0.1·N and offsets 0.1·N."""
    specs = param_specs(cfg)
    sizes = [math.prod(shape) for _, shape in specs]
    z = torch.randn(sum(sizes), generator=torch_generator(seed, device), device=device)
    out, off = {}, 0
    for (name, shape), n in zip(specs, sizes):
        v = z[off:off + n].view(shape)
        off += n
        if _is_ln(name):
            v = 1.0 + 0.1 * v if name.endswith("weight") else 0.1 * v
        elif name.endswith("bias"):
            v = 0.02 * v
        elif len(shape) == 3:
            v = v * math.sqrt(2.0 / (shape[1] * shape[2]))
        else:
            v = 0.02 * v
        out[name] = v.contiguous()
    return out


def window(clip: np.ndarray, j: int, n: int) -> np.ndarray:
    """Window j of a clip cut into non-overlapping n-sample windows, zeros
    past the clip's end."""
    out = np.zeros(n, np.float32)
    part = clip[j * n:(j + 1) * n]
    out[:len(part)] = part
    return out


def log_mel(pcm: torch.Tensor, cfg: dict) -> torch.Tensor:
    """(B, n) PCM → (B, n_mels, n / hop) float32."""
    n_fft, hop = cfg["n_fft"], cfg["hop_length"]
    x = F.pad(pcm.float()[:, None, :], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    hann = torch.from_numpy(dsp.periodic_hann(n_fft)).float().to(x.device)
    spec = torch.fft.rfft(x.unfold(-1, n_fft, hop) * hann, dim=-1)
    power = (spec.real**2 + spec.imag**2)[:, :-1].transpose(1, 2)
    fb = dsp.mel_filterbank(cfg["sr"], n_fft, cfg["n_mels"], 0.0, None, False)
    mel = torch.from_numpy(fb.astype(np.float32)).to(x.device) @ power
    log_spec = torch.log10(torch.clamp(mel, min=cfg["log_floor"]))
    log_spec = torch.maximum(log_spec, log_spec.amax(dim=(1, 2), keepdim=True) - cfg["log_range"])
    return (log_spec + cfg["log_offset"]) / cfg["log_scale"]


def sinusoids(length: int, channels: int, device) -> torch.Tensor:
    inc = math.log(10000.0) / (channels // 2 - 1)
    t = torch.arange(length, dtype=torch.float64)[:, None] * torch.exp(-inc * torch.arange(channels // 2))[None]
    return torch.cat([torch.sin(t), torch.cos(t)], 1).float().to(device)


def _linear(x, p, name, prec):
    w, b = p[name + ".weight"], p.get(name + ".bias")
    y = e4m3(x) @ e4m3(w).t() if prec == "fp8" else x @ w.t()
    return y if b is None else y + b


def _ln(x, p, name, eps):
    return F.layer_norm(x, x.shape[-1:], p[name + ".weight"], p[name + ".bias"], eps)


def _gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def _attention(x, p, name, n_head, prec):
    b, t, d = x.shape
    split = lambda y: y.view(b, t, n_head, d // n_head).permute(0, 2, 1, 3)  # noqa: E731
    scale = (d // n_head) ** -0.25
    q = split(_linear(x, p, name + ".query", prec)) * scale
    k = split(_linear(x, p, name + ".key", prec)) * scale
    w = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
    o = (w @ split(_linear(x, p, name + ".value", prec))).permute(0, 2, 1, 3).reshape(b, t, d)
    return _linear(o, p, name + ".out", prec)


def encoder(p: dict, mel: torch.Tensor, cfg: dict, prec: str = "f32") -> torch.Tensor:
    """(B, n_mels, 2 · n_audio_ctx) → (B, n_audio_ctx, n_audio_state)."""
    eps, heads = cfg["ln_eps"], cfg["n_audio_head"]
    x = _gelu(F.conv1d(mel, p["conv1.weight"], p["conv1.bias"], padding=1))
    x = _gelu(F.conv1d(x, p["conv2.weight"], p["conv2.bias"], stride=2, padding=1)).permute(0, 2, 1)
    x = x + sinusoids(x.shape[1], x.shape[2], x.device)
    for i in range(cfg["n_audio_layer"]):
        b = f"blocks.{i}."
        x = x + _attention(_ln(x, p, b + "attn_ln", eps), p, b + "attn", heads, prec)
        h = _gelu(_linear(_ln(x, p, b + "mlp_ln", eps), p, b + "mlp.0", prec))
        x = x + _linear(h, p, b + "mlp.2", prec)
    return _ln(x, p, "ln_post", eps)


def embed(p: dict, pcm: torch.Tensor, cfg: dict, prec: str = "f32", block: int = 1) -> torch.Tensor:
    """(B, n_samples) PCM windows → (B, n_audio_ctx, n_audio_state) rows,
    float32 with TF32 off, `block` windows at a time."""
    out = []
    with torch.no_grad(), precision("fp8" if prec == "fp8" else "f32"):
        for i in range(0, pcm.shape[0], block):
            out.append(encoder(p, log_mel(pcm[i:i + block], cfg), cfg, prec))
    return torch.cat(out)
