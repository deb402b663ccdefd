"""Host-side video decode and image sizing (jax-free copies from
``l3embedding_tpu/data/video_io.py``).

Decoding is layered as in audio_io:

  1. Pre-decoded ``.npy`` / ``.npz`` frame arrays (T, H, W, 3) uint8, the
     test and corpus-cache format: numpy alone (``.npy`` is memory-mapped).
  2. An ``ffmpeg`` subprocess piping rawvideo RGB24 through its scale
     filter, when ``ffmpeg`` and ``ffprobe`` are present.
  3. imageio, when it has a working video plugin.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess

import numpy as np

MIN_SIDE = 256


def _ffmpeg_path():
    return shutil.which("ffmpeg")


def _ffprobe_path():
    return shutil.which("ffprobe")


def probe_video(path: str) -> tuple[int, int, float]:
    """(width, height, fps) via ffprobe."""
    ffprobe = _ffprobe_path()
    if ffprobe is None:
        raise RuntimeError("ffprobe not available")
    out = subprocess.run(
        [
            ffprobe, "-v", "error", "-select_streams", "v:0",
            "-show_entries", "stream=width,height,avg_frame_rate",
            "-of", "json", path,
        ],
        capture_output=True,
        check=True,
    )
    stream = json.loads(out.stdout)["streams"][0]
    num, den = stream["avg_frame_rate"].split("/")
    fps = float(num) / float(den) if float(den) else 30.0
    return int(stream["width"]), int(stream["height"]), fps


def scaled_dims(width: int, height: int, min_side: int = MIN_SIDE) -> tuple[int, int]:
    """Resize target so min(side) == min_side (reference sample.py:303-305
    uses ceil)."""
    scaling = min_side / min(width, height)
    return math.ceil(scaling * width), math.ceil(scaling * height)


def read_video_ffmpeg(path: str, min_side: int = MIN_SIDE) -> np.ndarray:
    ffmpeg = _ffmpeg_path()
    width, height, _fps = probe_video(path)
    new_w, new_h = scaled_dims(width, height, min_side)
    out = subprocess.run(
        [
            ffmpeg, "-v", "error", "-i", path,
            "-f", "rawvideo", "-pix_fmt", "rgb24",
            "-s", f"{new_w}x{new_h}", "-",
        ],
        capture_output=True,
        check=True,
    )
    frames = np.frombuffer(out.stdout, dtype=np.uint8)
    n = len(frames) // (new_w * new_h * 3)
    return frames[: n * new_w * new_h * 3].reshape(n, new_h, new_w, 3)


def read_video_imageio(path: str, min_side: int = MIN_SIDE) -> np.ndarray:
    import imageio

    reader = imageio.get_reader(path)
    frames = [np.asarray(f) for f in reader]
    reader.close()
    video = np.stack(frames)
    h, w = video.shape[1:3]
    if min(h, w) != min_side:
        # Nearest-neighbour resize on the host.
        new_w, new_h = scaled_dims(w, h, min_side)
        yi = np.clip((np.arange(new_h) * h / new_h).astype(int), 0, h - 1)
        xi = np.clip((np.arange(new_w) * w / new_w).astype(int), 0, w - 1)
        video = video[:, yi][:, :, xi]
    return video


def read_video(path: str, min_side: int = MIN_SIDE) -> np.ndarray:
    """Decode a video to (T, H, W, 3) uint8 with min(H, W) == min_side
    (pre-decoded ``.npy`` / ``.npz`` frames come back at their own size)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        # Memory-mapped: a caller that samples a few frames pages in only those.
        return np.load(path, allow_pickle=False, mmap_mode="r")
    if ext == ".npz":
        with np.load(path, allow_pickle=False) as obj:
            return obj["video"]
    if _ffmpeg_path() is not None and _ffprobe_path() is not None:
        return read_video_ffmpeg(path, min_side)
    try:
        return read_video_imageio(path, min_side)
    except Exception as e:
        raise RuntimeError(
            f"cannot decode video {path!r}: no ffmpeg binary and imageio "
            f"failed ({e}). Provide pre-decoded .npy/.npz frames instead."
        ) from e
