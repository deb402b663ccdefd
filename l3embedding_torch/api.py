"""One-call embedding API in the OpenL3 style (the audio and image halves
of ``l3embedding_tpu/api.py``), on the PyTorch port:

    import l3embedding_torch.api as l3api
    emb, ts = l3api.get_audio_embedding(audio, sr, weights_path="model.ckpt",
                                        input_repr="mel256", embedding_size=512)
    emb = l3api.get_image_embedding(images, weights_path="model.ckpt")

Framing follows openl3: ``center=True`` pads half a window of zeros at
the front so window k is centred at ``k * hop_size`` seconds, and a
trailing partial window is kept (zero-padded). ``reference_framing=True``
gives the reference pipeline's framing instead (trailing partial window
dropped). Resampling is scipy's polyphase resampler. Weights are the JAX
package's ``.ckpt`` files; ``weights_path=None`` gives a seeded random
model (for shape and latency work only). ``input_repr`` in {"linear",
"mel128", "mel256"} picks the model type (cnn_L3_orig / melspec1 /
melspec2); images are always 8192-d. Images of any size are min-side
resized to 256 (PIL bilinear, else nearest) and center-cropped to 224.
"""

from __future__ import annotations

import numpy as np
import torch

from .compat.from_jax import vision_from_jax_variables
from .data.audio_io import pcm2float, resample
from .data.video_io import scaled_dims
from .embed.extract import INIT_SEED, EmbeddingExtractor, _bucket, frame_uniform
from .models.embedding import vision_embedding_fn
from .training.checkpoints import load_variables

TARGET_SR = 48000

INPUT_REPRS = {
    "linear": "cnn_L3_orig",
    "mel128": "cnn_L3_melspec1",
    "mel256": "cnn_L3_melspec2",
}
AUDIO_EMBEDDING_SIZES = {512: "short", 6144: "original"}


def _resolve_model_type(input_repr: str, model_type: str | None) -> str:
    if model_type is not None:
        return model_type
    if input_repr not in INPUT_REPRS:
        raise ValueError(
            f'Invalid input_repr: "{input_repr}" (have: {sorted(INPUT_REPRS)};'
            " or pass model_type= directly)"
        )
    return INPUT_REPRS[input_repr]


def load_audio_embedding_model(
    weights_path: str | None = None,
    input_repr: str = "mel256",
    embedding_size: int = 512,
    *,
    model_type: str | None = None,
    fast: bool = False,
    device: str | torch.device = "cuda",
) -> EmbeddingExtractor:
    """Build the resident extractor `get_audio_embedding` uses. Load once
    and pass as ``model=`` when embedding many arrays. ``fast=True``
    selects the bf16 tower."""
    if embedding_size not in AUDIO_EMBEDDING_SIZES:
        raise ValueError(
            f"Invalid embedding_size: {embedding_size} "
            f"(have: {sorted(AUDIO_EMBEDDING_SIZES)})"
        )
    return EmbeddingExtractor(
        weights_path,
        _resolve_model_type(input_repr, model_type),
        AUDIO_EMBEDDING_SIZES[embedding_size],
        fast=fast,
        device=device,
    )


def _to_mono_float(audio: np.ndarray) -> np.ndarray:
    audio = np.asarray(audio)
    if np.issubdtype(audio.dtype, np.integer):
        audio = pcm2float(audio)  # scale before any float-producing mix
    if audio.ndim == 2:  # (samples, channels), soundfile convention
        audio = audio.mean(axis=1)
    elif audio.ndim != 1:
        raise ValueError(f"audio must be 1-D or 2-D, got shape {audio.shape}")
    return np.ascontiguousarray(audio, dtype=np.float32)


def _frame_openl3(audio: np.ndarray, sr: int, hop_size: float,
                  center: bool) -> np.ndarray:
    """openl3-semantics framing: front-centred, trailing partial kept."""
    frame_length = sr
    hop_length = int(hop_size * sr)
    if center:
        audio = np.pad(audio, (frame_length // 2, 0), mode="constant")
    if len(audio) <= frame_length:
        n = 1
    else:
        n = 1 + int(np.ceil((len(audio) - frame_length) / hop_length))
    need = (n - 1) * hop_length + frame_length
    if len(audio) < need:
        audio = np.pad(audio, (0, need - len(audio)), mode="constant")
    strides = (audio.strides[0] * hop_length, audio.strides[0])
    return np.lib.stride_tricks.as_strided(
        audio, shape=(n, frame_length), strides=strides
    ).astype(np.float32)


def get_audio_embedding(
    audio: np.ndarray,
    sr: int,
    model=None,
    *,
    weights_path: str | None = None,
    input_repr: str = "mel256",
    embedding_size: int = 512,
    model_type: str | None = None,
    hop_size: float = 0.1,
    center: bool = True,
    reference_framing: bool = False,
    fast: bool = False,
    device: str | torch.device = "cuda",
):
    """audio (+ its sample rate) → (embedding (N, dim) f32, ts (N,) s).

    ``model`` is an extractor from `load_audio_embedding_model` (or any
    object with ``embed_windows``); when omitted one is built from the
    other keyword arguments. Timestamps are window starts, which with
    ``center=True`` are the window centres in the original signal.

    A list/tuple of arrays returns ``(embeddings, timestamps)`` lists, with
    one model shared by all; ``sr`` may be one rate or a matching list.
    """
    if model is None:
        model = load_audio_embedding_model(
            weights_path, input_repr, embedding_size,
            model_type=model_type, fast=fast, device=device,
        )
    if isinstance(audio, (list, tuple)):
        srs = sr if isinstance(sr, (list, tuple)) else [sr] * len(audio)
        if len(srs) != len(audio):
            raise ValueError(
                f"{len(audio)} audio arrays but {len(srs)} sample rates"
            )
        pairs = [
            get_audio_embedding(
                a, s, model=model, hop_size=hop_size, center=center,
                reference_framing=reference_framing,
            )
            for a, s in zip(audio, srs)
        ]
        return [e for e, _ in pairs], [t for _, t in pairs]
    audio = _to_mono_float(audio)
    target_sr = getattr(model, "sr", TARGET_SR)
    if sr != target_sr:
        audio = resample(audio, sr, target_sr)
    if reference_framing:
        windows = frame_uniform(audio, target_sr, hop_size)
    else:
        windows = _frame_openl3(audio, target_sr, hop_size, center)
    embedding = model.embed_windows(windows)
    timestamps = np.arange(embedding.shape[0], dtype=np.float64) * hop_size
    return embedding, timestamps


def _resize_min_side(frame: np.ndarray, min_side: int = 256) -> np.ndarray:
    """(H, W, 3) uint8 → min(H, W) == min_side (reference
    data/avc/sample.py:303-305 scaling, ceil semantics)."""
    h, w = frame.shape[:2]
    if min(h, w) == min_side:
        return frame
    new_w, new_h = scaled_dims(w, h, min_side)
    try:
        from PIL import Image

        return np.asarray(
            Image.fromarray(frame).resize((new_w, new_h), Image.BILINEAR)
        )
    except ImportError:
        yi = np.clip((np.arange(new_h) * h / new_h).astype(int), 0, h - 1)
        xi = np.clip((np.arange(new_w) * w / new_w).astype(int), 0, w - 1)
        return frame[yi][:, xi]


def _center_crop(frames: np.ndarray, size: int = 224) -> np.ndarray:
    """(N, H, W, 3) → (N, size, size, 3), centered (the deterministic
    inference counterpart of training's random 224-crop,
    reference data/avc/sample.py:318-328)."""
    h, w = frames.shape[1:3]
    if h < size or w < size:
        raise ValueError(f"frames {h}x{w} smaller than crop {size}")
    y0 = (h - size) // 2
    x0 = (w - size) // 2
    return frames[:, y0 : y0 + size, x0 : x0 + size]


def preprocess_frames(frames: np.ndarray) -> np.ndarray:
    """Arbitrary-size (N|1, H, W, 3) uint8 frames → (N, 224, 224, 3):
    min-side resize to 256, center crop 224."""
    frames = np.asarray(frames)
    if frames.ndim == 3:
        frames = frames[None]
    if frames.shape[1:3] == (224, 224):
        return frames
    frames = np.stack([_resize_min_side(f) for f in frames])
    return _center_crop(frames)


class ImageEmbeddingModel:
    """Resident vision-embedding extractor (8192-d, reference
    vision_model.py:198-218), f32, with the audio path's power-of-two
    batch buckets. weights_path=None gives a seeded random model (He-normal
    kernels from a ``torch.Generator`` seeded with INIT_SEED)."""

    def __init__(self, weights_path: str | None = None,
                 input_repr: str = "mel256",
                 model_type: str | None = None,
                 device: str | torch.device = "cuda"):
        self.model_type = _resolve_model_type(input_repr, model_type)
        self.device = torch.device(device)
        model = vision_embedding_fn(self.model_type)
        if weights_path is None:
            model.tower.reset_parameters(torch.Generator().manual_seed(INIT_SEED))
        else:
            model.tower.load_state_dict(
                vision_from_jax_variables(load_variables(weights_path), self.model_type)
            )
        self.model = model.eval().to(self.device)

    def embed_frames(self, frames: np.ndarray) -> np.ndarray:
        """(N, 224, 224, 3) uint8 [0,255] or float [-1,1] → (N, 8192)."""
        frames = np.asarray(frames)
        if frames.ndim == 3:
            frames = frames[None]
        if frames.dtype == np.uint8:
            # Training preprocessing convention (training/steps.py).
            frames = 2.0 * (frames.astype(np.float32) / 255.0) - 1.0
        frames = frames.astype(np.float32, copy=False)
        n = frames.shape[0]
        bucket = _bucket(n)
        if bucket != n:
            frames = np.concatenate(
                [frames, np.zeros((bucket - n,) + frames.shape[1:], np.float32)]
            )
        x = torch.from_numpy(frames).to(self.device)
        return self.model(x)[:n].cpu().numpy()


def get_image_embedding(
    images: np.ndarray,
    frame_rate: float | None = None,
    model: ImageEmbeddingModel | None = None,
    *,
    weights_path: str | None = None,
    input_repr: str = "mel256",
    model_type: str | None = None,
    device: str | torch.device = "cuda",
):
    """(N, H, W, 3) images (uint8 or [-1,1] float) → (N, 8192).

    Arbitrary H/W are min-side-resized to 256 and center-cropped to 224
    (uint8 only; pre-scaled float input must already be 224x224). With
    ``frame_rate`` (video frames), returns ``(embedding, timestamps)``
    where ``timestamps[k] = k / frame_rate`` (openl3's video semantics).

    A list/tuple of image arrays returns per-input results with one shared
    model: a list of embeddings, or ``(embeddings, timestamps)`` lists
    when ``frame_rate`` is given (scalar or per-input list).
    """
    if model is None:
        model = ImageEmbeddingModel(weights_path, input_repr, model_type, device)
    if isinstance(images, (list, tuple)):
        frs = (frame_rate if isinstance(frame_rate, (list, tuple))
               else [frame_rate] * len(images))
        if len(frs) != len(images):
            raise ValueError(
                f"{len(images)} image arrays but {len(frs)} frame rates"
            )
        outs = [get_image_embedding(im, fr, model=model)
                for im, fr in zip(images, frs)]
        if frame_rate is None:
            return outs
        return [e for e, _ in outs], [t for _, t in outs]
    images = np.asarray(images)
    if images.dtype == np.uint8:
        images = preprocess_frames(images)
    emb = model.embed_frames(images)
    if frame_rate is not None:
        ts = np.arange(emb.shape[0], dtype=np.float64) / float(frame_rate)
        return emb, ts
    return emb
