"""A plain float32 reference of Whisper's log-mel front end and audio
encoder, written from the published equations (openai/whisper,
``whisper/audio.py::log_mel_spectrogram``, ``whisper/model.py::AudioEncoder``)
for the port's CPU tests. Plain torch and numpy: it imports no JAX and
nothing of ``l3embedding_torch``, and builds its own tables.

Front end: reflect padding of 200 samples on each side, 400-sample frames
at hop 160 under the periodic Hann window, the one-sided DFT, |X|² with
the last frame dropped, the Slaney-scale mel filters with Slaney's area
norm (librosa's ``filters.mel(sr=16000, n_fft=400)``), log10(max(m,
1e-10)), clamped below at the max − 8, then (x + 4) / 4.

Encoder, on a dict of tensors in Whisper's state-dict names:
GELU(conv1), GELU(conv2, stride 2), + sinusoids, per block
x += out(attention(LN(x))), x += fc2(GELU(fc1(LN(x)))), then ln_post.
Attention: q and k each scaled by head^-¼, softmax over keys, no mask.

Departures from openai/whisper: the clamp's max is taken per window, where
Whisper's is over its whole input (one window in ``transcribe``); on the
card the reference keeps TF32 off, where Whisper would take the
backend's default. None other.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

SR, N_FFT, HOP = 16000, 400, 160


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, np.log(6.4) / 27.0
    return np.where(f >= min_log_hz, min_log_mel + np.log(np.maximum(f, 1e-30) / min_log_hz) / logstep, f / f_sp)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), f_sp * m)


def mel_filters(n_mels: int) -> np.ndarray:
    """(n_mels, 201) float64 Slaney filters with Slaney's norm, 0 to 8 kHz."""
    fft_freqs = np.linspace(0.0, SR / 2, N_FFT // 2 + 1)
    pts = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(SR / 2), n_mels + 2))
    lower = (fft_freqs[None, :] - pts[:-2, None]) / (pts[1:-1] - pts[:-2])[:, None]
    upper = (pts[2:, None] - fft_freqs[None, :]) / (pts[2:] - pts[1:-1])[:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    return weights * (2.0 / (pts[2:] - pts[:-2]))[:, None]


def log_mel(pcm: torch.Tensor, n_mels: int) -> torch.Tensor:
    """(B, n) float32 PCM → (B, n_mels, n // 160) float32."""
    x = F.pad(pcm.float()[:, None, :], (N_FFT // 2, N_FFT // 2), mode="reflect")[:, 0]
    frames = x.unfold(-1, N_FFT, HOP)  # (B, n // 160 + 1, 400)
    window = torch.from_numpy(0.5 - 0.5 * np.cos(2 * np.pi * np.arange(N_FFT) / N_FFT)).float()
    spec = torch.fft.rfft(frames * window.to(x.device), dim=-1)  # (B, T + 1, 201)
    power = (spec.real**2 + spec.imag**2)[:, :-1].transpose(1, 2)  # (B, 201, T)
    mel = torch.from_numpy(mel_filters(n_mels)).float().to(x.device) @ power
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    log_spec = torch.maximum(log_spec, log_spec.amax(dim=(1, 2), keepdim=True) - 8.0)
    return (log_spec + 4.0) / 4.0


def sinusoids(length: int, channels: int) -> torch.Tensor:
    inc = math.log(10000.0) / (channels // 2 - 1)
    t = torch.arange(length, dtype=torch.float64)[:, None] * torch.exp(-inc * torch.arange(channels // 2))[None]
    return torch.cat([torch.sin(t), torch.cos(t)], 1).float()


def _ln(x, p, name):
    return F.layer_norm(x, x.shape[-1:], p[name + ".weight"], p[name + ".bias"], 1e-5)


def _gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def _attention(x, p, name, n_head):
    b, t, d = x.shape
    hd = d // n_head
    q = x @ p[name + ".query.weight"].t() + p[name + ".query.bias"]
    k = x @ p[name + ".key.weight"].t()
    v = x @ p[name + ".value.weight"].t() + p[name + ".value.bias"]
    split = lambda y: y.view(b, t, n_head, hd).permute(0, 2, 1, 3)  # noqa: E731
    scale = hd**-0.25
    w = torch.softmax((split(q) * scale) @ (split(k) * scale).transpose(-1, -2), dim=-1)
    o = (w @ split(v)).permute(0, 2, 1, 3).reshape(b, t, d)
    return o @ p[name + ".out.weight"].t() + p[name + ".out.bias"]


def encoder(p: dict, mel: torch.Tensor, n_head: int) -> torch.Tensor:
    """(B, n_mels, 2·n_ctx) → (B, n_ctx, n_state), float32; `p` holds the
    encoder's tensors under Whisper's names."""
    x = _gelu(F.conv1d(mel, p["conv1.weight"], p["conv1.bias"], padding=1))
    x = _gelu(F.conv1d(x, p["conv2.weight"], p["conv2.bias"], stride=2, padding=1)).permute(0, 2, 1)
    x = x + sinusoids(x.shape[1], x.shape[2]).to(x.device)
    i = 0
    while f"blocks.{i}.attn_ln.weight" in p:
        blk = f"blocks.{i}"
        x = x + _attention(_ln(x, p, blk + ".attn_ln"), p, blk + ".attn", n_head)
        h = _gelu(_ln(x, p, blk + ".mlp_ln") @ p[blk + ".mlp.0.weight"].t() + p[blk + ".mlp.0.bias"])
        x = x + h @ p[blk + ".mlp.2.weight"].t() + p[blk + ".mlp.2.bias"]
        i += 1
    return _ln(x, p, "ln_post")


def embed(p: dict, pcm: torch.Tensor, n_mels: int, n_head: int) -> torch.Tensor:
    """(B, 2·n_ctx·160) PCM windows → (B, n_ctx, n_state) rows, float32 with
    TF32 off."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return encoder(p, log_mel(pcm, n_mels), n_head)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def random_params(n_mels: int, n_state: int, n_layer: int, seed: int) -> dict:
    """Seeded float32 tensors in Whisper's names: linear weights N(0, 0.02),
    conv weights He-normal, biases N(0, 0.02), LayerNorm scales 1 + 0.1·N
    and offsets 0.1·N."""
    g = torch.Generator().manual_seed(seed)
    shapes = {"conv1.weight": (n_state, n_mels, 3), "conv1.bias": (n_state,),
              "conv2.weight": (n_state, n_state, 3), "conv2.bias": (n_state,)}
    for i in range(n_layer):
        b = f"blocks.{i}."
        for lin in ("attn.query", "attn.key", "attn.value", "attn.out"):
            shapes[b + lin + ".weight"] = (n_state, n_state)
            if lin != "attn.key":
                shapes[b + lin + ".bias"] = (n_state,)
        shapes.update({b + "mlp.0.weight": (4 * n_state, n_state), b + "mlp.0.bias": (4 * n_state,),
                       b + "mlp.2.weight": (n_state, 4 * n_state), b + "mlp.2.bias": (n_state,)})
        for ln in ("attn_ln", "mlp_ln"):
            shapes.update({b + ln + ".weight": (n_state,), b + ln + ".bias": (n_state,)})
    shapes.update({"ln_post.weight": (n_state,), "ln_post.bias": (n_state,)})
    out = {}
    for name, shape in shapes.items():
        z = torch.randn(shape, generator=g)
        if "_ln." in name or name.startswith("ln_post"):
            z = 1.0 + 0.1 * z if name.endswith("weight") else 0.1 * z
        elif name.endswith("bias"):
            z = 0.02 * z
        elif len(shape) == 3:
            z = z * math.sqrt(2.0 / (shape[1] * 3))
        else:
            z = 0.02 * z
        out[name] = z
    return out
