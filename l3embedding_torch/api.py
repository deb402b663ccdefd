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

Files: ``process_audio_file``, ``process_image_file`` and
``process_video_file`` write one ``.npz`` per input with openl3's names and
keys, and ``python -m l3embedding_torch.api FILES... [--device cpu]`` is
the CLI over them. ``int8_artifact=`` (``--int8-artifact``) serves a
calibrated int8 artifact of either package (``embed/quantized.py``).
"""

from __future__ import annotations

import os
import subprocess

import numpy as np
import torch

from .data.audio_io import load_audio, pcm2float, read_via_ffmpeg, resample
from .data.video_io import _ffprobe_path, probe_video, read_video, scaled_dims
from .embed.extract import EmbeddingExtractor, _bucket, frame_uniform
from .models.embedding import vision_embedding_fn
from .models.loading import load_model

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
    int8_artifact: str | None = None,
    devices=None,
    device_framing: bool = False,
    device: str | torch.device = "cuda",
) -> EmbeddingExtractor:
    """Build the resident extractor `get_audio_embedding` uses. Load once
    and pass as ``model=`` when embedding many arrays. ``fast=True``
    selects the bf16 tower; ``devices`` (the JAX package's ``mesh``) splits
    every bucket over several devices; ``device_framing`` cuts a clip's
    windows on the device in ``embed_audio``. ``int8_artifact`` loads a
    calibrated int8 artifact (``embed/quantized.py``, either package's)
    instead, its recorded accuracy gate re-checked at 0.999."""
    if int8_artifact is not None:
        from .embed.quantized import QuantizedEmbeddingExtractor

        return QuantizedEmbeddingExtractor.load_artifact(
            int8_artifact, devices=devices, device_framing=device_framing, device=device
        )
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
        devices=devices,
        device_framing=device_framing,
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
    batch buckets. The weights come through ``models.loading.load_model``:
    a ``.ckpt``, a reference Keras ``.h5``, or, for weights_path=None, a
    seeded random model (He-normal kernels from a ``torch.Generator`` seeded
    with INIT_SEED)."""

    def __init__(self, weights_path: str | None = None,
                 input_repr: str = "mel256",
                 model_type: str | None = None,
                 device: str | torch.device = "cuda"):
        self.model_type = _resolve_model_type(input_repr, model_type)
        self.device = torch.device(device)
        model = vision_embedding_fn(self.model_type)
        avc, _ = load_model(weights_path, self.model_type, device="cpu")
        model.tower.load_state_dict(avc.vision_model.state_dict())
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
        # The bucket's zero rows are made on the device; only real rows cross.
        x = torch.zeros((_bucket(n),) + frames.shape[1:], dtype=torch.float32, device=self.device)
        x[:n].copy_(torch.from_numpy(np.ascontiguousarray(frames)))
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


def _out_path(path: str, output_dir: str | None, name: str) -> str:
    return os.path.join(output_dir or os.path.dirname(path) or ".", name)


def _save_npz(out: str, **arrays) -> None:
    tmp = out + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, out)


def process_audio_file(
    filepath: str | list[str] | tuple[str, ...],
    output_dir: str | None = None,
    suffix: str | None = None,
    model=None,
    *,
    overwrite: bool = True,
    hop_size: float = 0.1,
    center: bool = True,
    **model_kwargs,
):
    """Embed audio file(s) → ``<name>[_<suffix>].npz`` with keys
    ``embedding`` and ``timestamps`` (the openl3 on-disk convention).

    Returns the output path (or list of paths). Without ``model``, one is
    built from ``model_kwargs`` (`load_audio_embedding_model`'s, including
    ``device``) and shared by every file.
    """
    paths = [filepath] if isinstance(filepath, (str, os.PathLike)) else list(filepath)
    if model is None and paths:
        model = load_audio_embedding_model(**model_kwargs)
    target_sr = getattr(model, "sr", TARGET_SR)
    outputs = []
    for path in paths:
        stem = os.path.splitext(os.path.basename(path))[0]
        out = _out_path(path, output_dir, f"{stem}_{suffix}.npz" if suffix else f"{stem}.npz")
        if overwrite or not os.path.exists(out):
            audio = load_audio(path, target_sr)
            emb, ts = get_audio_embedding(audio, target_sr, model=model, hop_size=hop_size, center=center)
            _save_npz(out, embedding=emb, timestamps=ts)
        outputs.append(out)
    if isinstance(filepath, (str, os.PathLike)):
        return outputs[0]
    return outputs


def process_image_file(
    filepath: str | list[str] | tuple[str, ...],
    output_dir: str | None = None,
    suffix: str | None = None,
    model: ImageEmbeddingModel | None = None,
    *,
    overwrite: bool = True,
    **model_kwargs,
):
    """Embed image file(s) → ``<name>[_<suffix>].npz`` with key
    ``embedding`` (openl3's image on-disk convention; one image gives a 1-D
    vector). ``.npy`` pre-decoded (H, W, 3) uint8 arrays need numpy alone;
    PNG/JPEG are read with PIL."""
    paths = [filepath] if isinstance(filepath, (str, os.PathLike)) else list(filepath)
    if model is None and paths:
        model = ImageEmbeddingModel(**model_kwargs)
    outputs = []
    for path in paths:
        stem = os.path.splitext(os.path.basename(path))[0]
        out = _out_path(path, output_dir, f"{stem}_{suffix}.npz" if suffix else f"{stem}.npz")
        if overwrite or not os.path.exists(out):
            if path.lower().endswith(".npy"):
                image = np.load(path, allow_pickle=False)
            else:
                from PIL import Image

                image = np.asarray(Image.open(path).convert("RGB"))
            emb = get_image_embedding(image, model=model)
            _save_npz(out, embedding=emb[0] if emb.shape[0] == 1 else emb)
        outputs.append(out)
    if isinstance(filepath, (str, os.PathLike)):
        return outputs[0]
    return outputs


def _video_audio_track(path: str, target_sr: int) -> np.ndarray | None:
    """Mono f32 audio track of a video, or None when the container has no
    decodable audio (pre-decoded .npy frame dumps, an .npz without an
    ``audio`` key, no ffmpeg)."""
    if path.lower().endswith(".npz"):
        with np.load(path, allow_pickle=False) as obj:
            if "audio" not in obj.files:
                return None
        return load_audio(path, target_sr)
    if path.lower().endswith(".npy"):
        return None
    try:
        data, _ = read_via_ffmpeg(path, target_sr=target_sr)
    except (RuntimeError, OSError, subprocess.CalledProcessError):  # no ffmpeg, or a video-only container
        return None
    if data.size == 0:
        return None
    return pcm2float(data[:, 0])


def _video_fps(path: str, source_fps: float | None) -> float:
    if source_fps is not None:
        return float(source_fps)
    if path.lower().endswith(".npz"):
        with np.load(path, allow_pickle=False) as obj:
            if "fps" in obj.files:
                return float(obj["fps"])
    if not path.lower().endswith((".npy", ".npz")) and _ffprobe_path() is not None:
        return probe_video(path)[2]
    return 30.0


def process_video_file(
    filepath: str | list[str] | tuple[str, ...],
    output_dir: str | None = None,
    suffix: str | None = None,
    audio_model=None,
    image_model: ImageEmbeddingModel | None = None,
    *,
    overwrite: bool = True,
    hop_size: float = 0.1,
    frame_rate: float = 1.0,
    source_fps: float | None = None,
    **model_kwargs,
):
    """Embed both modalities of video file(s) → ``<name>_audio[_<suffix>].npz``
    and ``<name>_image[_<suffix>].npz`` (openl3's convention), each with
    ``embedding`` and ``timestamps`` keys; returns ``{"audio": path or None,
    "image": path}`` per input.

    Frames are sampled at ``frame_rate`` fps (source fps from ffprobe, an
    ``fps`` npz key, or ``source_fps=``; 30 for bare ``.npy`` dumps).
    Containers without an audio track (``.npy``, an ``.npz`` without
    ``audio``) give only the image file. ``model_kwargs`` (input_repr,
    embedding_size, weights_path, device, ...) build the audio model when
    ``audio_model`` is omitted; the vision model shares input_repr,
    model_type, weights_path and device.
    """
    paths = [filepath] if isinstance(filepath, (str, os.PathLike)) else list(filepath)
    if image_model is None and paths:
        image_model = ImageEmbeddingModel(
            weights_path=model_kwargs.get("weights_path"),
            input_repr=model_kwargs.get("input_repr", "mel256"),
            model_type=model_kwargs.get("model_type"),
            device=model_kwargs.get("device", "cuda"),
        )
    outputs = []
    for path in paths:
        stem = os.path.splitext(os.path.basename(path))[0]
        tag = f"_{suffix}" if suffix else ""
        out_audio = _out_path(path, output_dir, f"{stem}_audio{tag}.npz")
        out_image = _out_path(path, output_dir, f"{stem}_image{tag}.npz")
        entry = {"audio": None, "image": out_image}

        if overwrite or not os.path.exists(out_image):
            frames = read_video(path)  # an mmap for .npy
            fps = _video_fps(path, source_fps)
            step = max(1, int(round(fps / frame_rate)))
            sampled = np.asarray(frames[::step])  # page in only these
            emb, ts = get_image_embedding(sampled, frame_rate=fps / step, model=image_model)
            _save_npz(out_image, embedding=emb, timestamps=ts)

        target_sr = getattr(audio_model, "sr", TARGET_SR)
        audio = _video_audio_track(path, target_sr)
        if audio is not None:
            entry["audio"] = out_audio
            if overwrite or not os.path.exists(out_audio):
                if audio_model is None:
                    audio_model = load_audio_embedding_model(**model_kwargs)
                emb, ts = get_audio_embedding(audio, target_sr, model=audio_model, hop_size=hop_size)
                _save_npz(out_audio, embedding=emb, timestamps=ts)
        outputs.append(entry)
    if isinstance(filepath, (str, os.PathLike)):
        return outputs[0]
    return outputs


def main(argv=None):
    """openl3-style CLI: ``python -m l3embedding_torch.api FILES...``."""
    import argparse

    p = argparse.ArgumentParser(
        prog="l3embedding_torch.api",
        description="Extract L3 embeddings from audio/image/video files "
        "(one .npz per input, openl3 on-disk conventions).",
    )
    p.add_argument("inputs", nargs="+", help="audio/image/video files")
    p.add_argument("--modality", choices=["audio", "image", "video"], default="audio")
    p.add_argument("--weights-path", default=None, help=".ckpt written by the JAX package")
    p.add_argument("--input-repr", default="mel256", choices=sorted(INPUT_REPRS))
    p.add_argument("--embedding-size", type=int, default=512, choices=sorted(AUDIO_EMBEDDING_SIZES))
    p.add_argument("--model-type", default=None, help="registry name override (e.g. tiny_L3)")
    p.add_argument("--output-dir", default=None)
    p.add_argument("--suffix", default=None)
    p.add_argument("--hop-size", type=float, default=0.1)
    p.add_argument("--no-centering", action="store_true")
    p.add_argument("--video-frame-rate", type=float, default=1.0, help="frames/sec to embed from videos")
    p.add_argument("--fast", action="store_true", help="bf16 tower")
    p.add_argument("--int8-artifact", default=None,
                   help="calibrated int8 deployment artifact (embed/quantized.py save_artifact output)")
    p.add_argument("--no-overwrite", action="store_true")
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu for the plain versions)")
    args = p.parse_args(argv)

    common = dict(output_dir=args.output_dir, suffix=args.suffix, overwrite=not args.no_overwrite)
    if args.modality == "image":
        outs = process_image_file(
            list(args.inputs), weights_path=args.weights_path, input_repr=args.input_repr,
            model_type=args.model_type, device=args.device, **common)
    elif args.modality == "video":
        entries = process_video_file(
            list(args.inputs), hop_size=args.hop_size, frame_rate=args.video_frame_rate,
            weights_path=args.weights_path, input_repr=args.input_repr,
            embedding_size=args.embedding_size, model_type=args.model_type,
            fast=args.fast, int8_artifact=args.int8_artifact, device=args.device, **common)
        outs = [o for e in entries for o in (e["audio"], e["image"]) if o]
    else:
        model = load_audio_embedding_model(
            args.weights_path, args.input_repr, args.embedding_size,
            model_type=args.model_type, fast=args.fast,
            int8_artifact=args.int8_artifact, device=args.device)
        outs = process_audio_file(
            list(args.inputs), model=model, hop_size=args.hop_size,
            center=not args.no_centering, **common)
    for out in outs:
        print(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
