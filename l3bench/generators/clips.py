"""Mixes of kind ``"clips"``: a closed loop of audio clips.

The file fixes a cycle of clip lengths (``fixed``: lengths with their
counts; ``uniform``: a range cut into that many strata, one length each),
so that every seed runs the same multiset of lengths. The seed permutes the
order of each pass over the cycle, and sets the PCM: each clip is a slice,
at a seeded offset, of one pool of seeded noise. The same seed gives the
same clips on the same kind of device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..generate import torch_generator


def cycle_lengths(mix: dict) -> list[float]:
    """The clip lengths of one pass of a clips mix, in seconds, in file order."""
    out = []
    for seconds, count in mix["lengths"].get("fixed", []):
        out += [float(seconds)] * int(count)
    uni = mix["lengths"].get("uniform")
    if uni:
        lo, hi, n = float(uni["low"]), float(uni["high"]), int(uni["count"])
        out += [lo + (hi - lo) * (i + 0.5) / n for i in range(n)]
    return out


class ClipStream:
    """Clip k of a run: ``length(k)`` samples of the pool from a seeded
    offset. ``clip(k)`` is a float32 numpy view (no copy per clip)."""

    def __init__(self, mix: dict, seed: int, device: str = "cpu", sr: int = 48000):
        self.sr = sr
        self.lengths = [int(round(s * sr)) for s in cycle_lengths(mix)]
        rng = np.random.default_rng(int(seed))
        self._order_rng = rng
        self._orders: list[np.ndarray] = []
        pool_len = int(round(float(mix["pool_seconds"]) * sr))
        longest = max(self.lengths)
        if pool_len < 2 * longest:
            raise ValueError("traffic: pool_seconds must cover twice the longest clip")
        g = torch_generator(seed, device)
        pool = torch.randn(pool_len, generator=g, device=device) * float(mix["amplitude"])
        self.pool = pool.clamp_(-1.0, 1.0).cpu().numpy()
        self._offsets = rng.integers(0, pool_len - longest, size=len(self.lengths))

    def _slot(self, k: int) -> int:
        n = len(self.lengths)
        while len(self._orders) <= k // n:
            self._orders.append(self._order_rng.permutation(n))
        return int(self._orders[k // n][k % n])

    def length(self, k: int) -> int:
        return self.lengths[self._slot(k)]

    def clip(self, k: int) -> np.ndarray:
        i = self._slot(k)
        start = int(self._offsets[i])
        return self.pool[start:start + self.lengths[i]]

    def distinct_lengths(self) -> list[int]:
        return sorted(set(self.lengths))
