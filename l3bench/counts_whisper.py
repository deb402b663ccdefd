"""Operations of Whisper's audio encoder, from the configuration's shapes
alone: the arithmetic behind ``mfu.encode`` and ``attn_roofline.encode``.
A multiply-add counts two. The peaks are ``counts.PEAK_FLOPS``'."""

from __future__ import annotations


def linear_flops(cfg: dict) -> float:
    """Every block's q, k, v, out and MLP products over one window's
    positions: 2 · n_ctx · n_layer · (4 d² + 2 d · n_mlp)."""
    d, t = cfg["n_audio_state"], cfg["n_audio_ctx"]
    return 2.0 * t * cfg["n_audio_layer"] * (4 * d * d + 2 * d * cfg["n_mlp"])


def attn_flops(cfg: dict) -> float:
    """The attention cores of one window: q·kᵀ and the weights' product with
    v, each 2 · n_ctx² · d a block (the softmax left out)."""
    t = cfg["n_audio_ctx"]
    return 4.0 * cfg["n_audio_layer"] * t * t * cfg["n_audio_state"]


def stem_flops(cfg: dict) -> float:
    """conv1 over 2 · n_ctx mel frames and conv2 (stride 2) over n_ctx, kernel 3."""
    d, t = cfg["n_audio_state"], cfg["n_audio_ctx"]
    return 2.0 * (2 * t) * (3 * cfg["n_mels"]) * d + 2.0 * t * (3 * d) * d


def window_flops(cfg: dict) -> float:
    """One 30 s window through the encoder: linears, attention cores and
    stem (the float32 front end, ~0.05 % of it, left out)."""
    return linear_flops(cfg) + attn_flops(cfg) + stem_flops(cfg)
