"""Host-side image sizing (a jax-free copy from ``l3embedding_tpu/data/video_io.py``)."""

from __future__ import annotations

import math

MIN_SIDE = 256


def scaled_dims(width: int, height: int, min_side: int = MIN_SIDE) -> tuple[int, int]:
    """Resize target so min(side) == min_side (reference sample.py:303-305
    uses ceil)."""
    scaling = min_side / min(width, height)
    return math.ceil(scaling * width), math.ceil(scaling * height)
