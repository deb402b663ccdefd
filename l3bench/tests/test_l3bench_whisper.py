"""The Whisper encoder cell on the CPU at a small size: the reference agrees
with the program, the counts are the model's, a run comes out correct and
reads its per-layer metrics, and each planted fault comes out not correct.
The configuration keeps the cell's front end and keys, at d 64, 2 blocks,
4 heads, 16 mels and 200 positions (4 s windows)."""

import json
import math
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from l3bench import check, context, counts_whisper, generate, run
from l3bench.drivers import encode
from l3bench.reference import whisper as ref

FAULTS = "l3bench.tests.faults_whisper:"
SEED = 2**31 + 77
WORKLOAD = "whisper.encode.bf16"


def published():
    return json.loads((run.HERE / "configs" / "whisper_large_v3_encoder.json").read_text())


def small():
    return {**published(), "n_mels": 16, "n_audio_ctx": 200, "n_audio_state": 64, "n_audio_head": 4,
            "n_audio_layer": 2, "n_mlp": 256, "n_samples": 64000}


def _run(plant=None, trace=False, controls=(), sample=4, seconds=0.4):
    _, _, cell, _, mix = run.load_cell(WORKLOAD)
    cell = {**cell, "warmup_s": 0, "trace": {"start": 1, "units": 2},
            "check": {**cell["check"], "sample": sample}}
    mix = {**mix, "lengths": {"uniform": {"low": 3.0, "high": 13.0, "count": 4}}, "pool_seconds": 30,
           "windows_per_call": 3}
    torch.set_num_threads(min(4, torch.get_num_threads()))
    ctx = context.Context(cell=cell, config=small(), mix=mix, seed=SEED, seconds=seconds, trace=trace,
                          device="cpu", t0=time.time(), controls=controls, plant=plant)
    return encode.run(ctx), cell


def test_published_counts():
    """2.274 TFLOP a window: 1.887 in the linears (2 · 1500 · 32 · the
    program's 19.66 M linear weights a block), 0.369 in the attention cores,
    0.018 in the stem."""
    from l3embedding_torch.models.whisper_encoder import WhisperEncoder

    cfg = published()
    with torch.device("meta"):
        enc = WhisperEncoder(encode.dims(cfg))
    weights = sum(p.numel() for n, p in enc.blocks.named_parameters() if n.endswith("weight") and p.dim() == 2)
    assert counts_whisper.linear_flops(cfg) == 2 * cfg["n_audio_ctx"] * weights
    assert counts_whisper.attn_flops(cfg) == 32 * 4 * 1500**2 * 1280
    assert math.isclose(counts_whisper.window_flops(cfg), 2.27377152e12)
    assert sum(math.prod(s) for _, s in ref.param_specs(cfg)) == sum(p.numel() for p in enc.parameters())


def test_reference_agrees_with_the_program():
    from l3embedding_torch.embed.whisper import WhisperExtractor, frame_whisper

    cfg = small()
    params = ref.make_weights(cfg, 5, "cpu")
    ext = WhisperExtractor(params, fast=False, device="cpu", dims=encode.dims(cfg))
    clip = np.random.default_rng(0).standard_normal(150_000).astype(np.float32) * 0.1
    got = ext.embed_audio(clip)
    windows = np.stack([ref.window(clip, j, cfg["n_samples"]) for j in range(3)])
    assert np.array_equal(windows, frame_whisper(clip, cfg["n_samples"])[0])
    want = ref.embed(params, torch.from_numpy(windows), cfg).numpy()
    assert got.shape == want.shape == (3, 200, 64)
    assert max(check.row_err(g, w) for g, w in zip(got, want)) < 1e-5


def test_packer_packs_windows_across_clips():
    """One cycle of the mix: 77 windows with 230 s of padding; each window
    the program's own cut of its clip, each call's pad its windows'."""
    from l3embedding_torch.embed.whisper import frame_whisper

    n = 480_000
    mix = generate.load_mix("longform30s")
    stream = generate.generator(mix).ClipStream(mix, SEED, "cpu", 16000)
    packer = encode.Packer(stream, n, 32)
    cut = {k: frame_whisper(stream.clip(k), n)[0] for k in range(20)}
    pads = []
    while packer.k < 16:
        windows, pad, ids = packer.next()
        assert windows.shape == (32, n) and len(ids) == 32
        for row, (k, j) in zip(windows, ids):
            assert np.array_equal(row, cut[k][j])
        pads.append((pad, ids))
        assert pad == sum(n - min(n, stream.length(k) - j * n) for k, j in ids)
    first = [w for _, ids in pads for w in ids if w[0] < 16]
    assert len(first) == 77 == sum(len(cut[k]) for k in range(16))
    assert sum(n - min(n, stream.length(k) - j * n) for k, j in first) == 230 * 16000


def test_a_run_is_correct_and_reads_its_metrics():
    record, cell = _run(trace=True, controls=("fp8",))
    ok, table = check.verdict(record["numbers"], cell["check"]["limits"])
    assert ok and record["failed"] == 0 and record["windows"] == record["attempted"] > 0, table
    assert record["numbers"]["checked_windows"] == 4 and record["numbers"]["window_err"] < 1e-2
    # At this width the linears add little to the residual stream, so the
    # fp8 control reads under the bf16 program here; it is read at the
    # published widths on the card.
    assert record["numbers"]["controls"]["fp8"]["window_err"] > 0
    assert record["trace_calls"] == 2
    rec = {**record, "cell": cell, "config": small(), "chips": 1}
    values = {m: run.reader(m)(rec) for m in ("mfu.encode", "attn_share.encode", "attn_roofline.encode",
                                              "padding_share.encode", "windows_per_s", "setup_s")}
    assert all(v is not None and v > 0 for v in values.values()), values
    assert values["attn_share.encode"] < 100
    from l3embedding_torch.utils import trace

    calls = trace.last("extract.call", 2)
    assert [c.counters["windows"] for c in calls] == [3, 3]
    pad = sum(c.counters["pad_samples"] for c in calls)
    assert math.isclose(values["padding_share.encode"], 100 * pad / (6 * 64000))


@pytest.mark.parametrize("fault", ["skip_block", "shift_positions", "alter_window", "nan_window"])
def test_a_fault_fails(fault):
    record, cell = _run(FAULTS + fault)
    ok, table = check.verdict(record["numbers"], cell["check"]["limits"])
    assert not (ok and record["failed"] == 0), table


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, '.')\n"
            "import l3bench.reference.whisper, l3bench.counts_whisper\n"
            "print(' '.join(sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, capture_output=True, text=True, check=True,
                         timeout=300)
    top = {m.split(".")[0] for m in out.stdout.split()}
    assert not top & (set(context.FORBIDDEN) | {"l3embedding_torch"}), top
