"""The traffic generators are deterministic in the seed, and every seed
runs the same sizes."""

import numpy as np
import pytest
import torch

from l3bench import generate
from l3bench.generators import avc_batches, clips

SEEDS = (0, 2**31 + 12345, 3 * 2**31 + 7)


def test_clip_stream_repeats_by_seed():
    m = generate.load_mix("clips10s")
    a, b = clips.ClipStream(m, SEEDS[1]), clips.ClipStream(m, SEEDS[1])
    c = clips.ClipStream(m, SEEDS[2])
    for k in range(0, 120, 7):
        assert np.array_equal(a.clip(k), b.clip(k))
    assert any(not np.array_equal(a.clip(k), c.clip(k)) for k in range(5))


def test_every_seed_runs_the_same_lengths():
    m = generate.load_mix("clips10s")
    n = len(clips.cycle_lengths(m))
    for seed in SEEDS:
        s = clips.ClipStream(m, seed)
        assert [s.length(k) for k in range(2 * n)] == [480_000] * (2 * n)


def test_a_ten_second_clip_is_91_windows_in_one_128_row_bucket():
    from l3embedding_torch.embed.extract import _bucket

    from l3bench.drivers.extract import _windows

    m = generate.load_mix("clips10s")
    n = _windows(clips.ClipStream(m, 1).length(0), 48000, m["hop_size"])
    assert n == 91 and _bucket(n) == 128


def test_pcm_lies_in_range():
    s = clips.ClipStream(generate.load_mix("clips10s"), 5)
    x = s.clip(3)
    assert x.dtype == np.float32 and np.abs(x).max() <= 1.0 and x.std() > 0.05


def _small(world=1):
    return {**generate.load_mix("avc_rows256"), "rows_per_card": 4, "pool": 3}, world


def test_avc_pool_repeats_by_seed_and_keeps_any_batch_alike():
    mix, world = _small()
    a = avc_batches.avc_pool(mix, SEEDS[1], "cpu", world)
    b = avc_batches.avc_pool(mix, SEEDS[1], "cpu", world, keep=range(1, 2))
    c = avc_batches.avc_pool(mix, SEEDS[2], "cpu", world)
    assert len(a) == 3 and len(b) == 1
    for k in ("video", "audio", "label"):
        assert torch.equal(a[1][k], b[0][k])
    assert not torch.equal(a[0]["video"], c[0]["video"])
    assert a[0]["video"].dtype == torch.uint8 and a[0]["audio"].dtype == torch.int16
    assert a[0]["video"].shape == (4, 224, 224, 3) and a[0]["audio"].shape == (4, 1, 48000)
    assert not torch.equal(a[0]["audio"], a[1]["audio"])


@pytest.mark.parametrize("world", [1, 4])
def test_half_of_every_global_batch_is_positive(world):
    mix, _ = _small()
    for batch in avc_batches.avc_pool(mix, SEEDS[0], "cpu", world):
        label = batch["label"]
        assert label.shape == (4 * world, 2)
        assert torch.equal(label.sum(1), torch.ones(4 * world))
        assert int(label[:, 0].sum()) == 2 * world
