"""Image ops: RGB↔HSV, saturation/brightness jitter, flips.

A copy of ``l3embedding_tpu/ops/image.py``: the reference's skimage-based
augmentation (reference l3embedding/image.py:5-49, duplicated in
data/avc/sample.py:24-69) in numpy float64. It is the plain version of the
native library's fused ``augment_frame`` (``l3embedding_torch/native.py``).
Semantics match skimage: float images in [0, 1], HSV roundtrip identical
to skimage.color.rgb2hsv/hsv2rgb.
"""

from __future__ import annotations

import numpy as np


def rgb_to_hsv(rgb: np.ndarray) -> np.ndarray:
    """(..., 3) float RGB in [0,1] → HSV (h in [0,1))."""
    rgb = np.asarray(rgb, dtype=np.float64)
    maxc = rgb.max(axis=-1)
    minc = rgb.min(axis=-1)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.where(maxc == 0, 1, maxc), 0.0)

    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    dd = np.where(delta == 0, 1.0, delta)
    rc = (maxc - r) / dd
    gc = (maxc - g) / dd
    bc = (maxc - b) / dd
    h = np.where(r == maxc, bc - gc, np.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = (h / 6.0) % 1.0
    h = np.where(delta == 0, 0.0, h)
    return np.stack([h, s, v], axis=-1)


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    hsv = np.asarray(hsv, dtype=np.float64)
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = (i.astype(np.int64) % 6)[..., None]
    out = np.select(
        [i == 0, i == 1, i == 2, i == 3, i == 4, i == 5],
        [
            np.stack([v, t, p], -1),
            np.stack([q, v, p], -1),
            np.stack([p, v, t], -1),
            np.stack([p, q, v], -1),
            np.stack([t, p, v], -1),
            np.stack([v, p, q], -1),
        ],
    )
    return out


def adjust_saturation(rgb_img: np.ndarray, factor: float) -> np.ndarray:
    """Scale HSV saturation by `factor`, clipped to [0,1]
    (reference image.py:5-20)."""
    hsv = rgb_to_hsv(rgb_img)
    hsv[..., 1] = np.clip(hsv[..., 1] * factor, 0.0, 1.0)
    return hsv_to_rgb(hsv)


def adjust_brightness(rgb_img: np.ndarray, delta: float) -> np.ndarray:
    """Add normalized `delta` to every channel, clipped to the image
    range (reference image.py:23-37)."""
    return np.clip(np.asarray(rgb_img, dtype=np.float64) + delta, 0.0, 1.0)


def horiz_flip(rgb_img: np.ndarray) -> np.ndarray:
    return rgb_img[:, ::-1, :]


def img_as_float(img: np.ndarray) -> np.ndarray:
    """uint8 → float64 in [0,1] (skimage.img_as_float semantics)."""
    if np.issubdtype(img.dtype, np.floating):
        return img
    return img.astype(np.float64) / 255.0


def img_as_ubyte(img: np.ndarray) -> np.ndarray:
    """float [0,1] → uint8, skimage rounding semantics (round-half-even
    via np.rint after scaling)."""
    if img.dtype == np.uint8:
        return img
    return np.rint(np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)
