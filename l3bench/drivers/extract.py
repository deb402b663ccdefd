"""Driver of the extraction cells: ``EmbeddingExtractor.embed_audio_async``
in the closed loop of the ``05`` corpus CLI.

As ``data/usc/datasets.py::_PendingWriter`` does, the loop keeps up to
``depth`` clips dispatched and takes the rows of the oldest once that many
are pending. The window's rate counts the real windows returned, over the
time from the first dispatch to the last rows: once the time is up nothing
more is sent, every clip in flight is waited for, and the clock is read
after that wait. Set-up runs the loop for ``warmup_s`` seconds before the
window, so that the card's clocks have settled under the load. A traced
run drains the loop, traces ``trace.units`` clips from clip
``trace.start``, and drains again.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from .. import check, generate, traces, weights
from ..context import resolve
from ..reference import model as ref
from . import _port

TOWER = {"audio": ""}  # the extractor's tower holds the audio leaves at its root


def _sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _windows(n_samples: int, sr: int, hop_size: float) -> int:
    """Rows the reference's framing gives a clip of n_samples."""
    return 1 if n_samples < sr else (n_samples - sr) // int(hop_size * sr) + 1


def _drain_loop(ext, stream, hop: float, depth: int, k0: int, seconds: float) -> int:
    """The closed loop, untimed, from clip k0 for `seconds`; → the next clip."""
    pending, k, stop = deque(), k0, time.perf_counter() + seconds
    while k == k0 or time.perf_counter() < stop:
        pending.append(ext.embed_audio_async(stream.clip(k), hop))
        k += 1
        while len(pending) >= depth:
            pending.popleft().result()
    while pending:
        pending.popleft().result()
    return k


def run(ctx) -> dict:
    from l3embedding_torch.embed.extract import EmbeddingExtractor

    cell, cfg, mix, device = ctx.cell, ctx.config, ctx.mix, ctx.device
    phases = [*ctx.marks, ("imports", time.time() - ctx.t0)]
    opts = cell["options"]
    sr = cfg["sr"]
    hop, depth = float(mix["hop_size"]), int(mix["depth"])
    params = weights.make(ref.param_specs(cfg, ("audio",)), ctx.seed, device)
    ext = EmbeddingExtractor(None, cfg["model_type"], opts["pooling"], fast=cell["precision"] == "bf16",
                             device_framing=bool(opts["device_framing"]), device=device)
    _port.load(ext.model.tower, params, TOWER)
    phases.append(("CUDA context, weights and extractor", time.time() - ctx.t0))
    stream = generate.generator(mix).ClipStream(mix, ctx.seed, device, sr)
    phases.append(("traffic", time.time() - ctx.t0))

    # Warm-up: each clip length of the mix, so every shape the window meets,
    # then the loop at its depth for warmup_s, so that the pinned host
    # buffers of the clips in flight exist and the card's clocks have
    # settled before the window.
    for n in stream.distinct_lengths():
        ext.embed_audio(stream.pool[:n], hop)
    phases.append(("first call of each clip length (kernel build on a first run)", time.time() - ctx.t0))
    k_warm = _drain_loop(ext, stream, hop, depth, 0, float(cell["warmup_s"]))
    phases.append((f"warm-up loop, {k_warm} clips", time.time() - ctx.t0))
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.device(device).type == "cuda" else [])
    if ctx.trace:  # the profiler's own first start, outside the window
        with profile(activities=activities):
            ext.embed_audio(stream.pool[:stream.distinct_lengths()[-1]], hop)
    _sync(device)
    setup_s = time.time() - ctx.t0
    phases.append(("profiler's first start" if ctx.trace else "synchronised", setup_s))
    if ctx.plant:  # the tests' faults break the timed path from the window's first clip
        resolve(ctx.plant)(ext)

    t_start = time.perf_counter()
    t_stop = t_start + ctx.seconds
    tr = cell["trace"]
    trace_from, trace_to = (tr["start"], tr["start"] + tr["units"]) if ctx.trace else (-1, -1)
    clips, rows, pending = [], {}, deque()
    prof = span = None
    tracing = False

    def collect():
        i, k, h, t_a, t_b = pending.popleft()
        with record_function("extract.collect"):
            out = h.result()
        t_c = time.perf_counter()
        rows[k] = out
        n = stream.length(k)
        clips.append({"k": k, "samples": n, "rows": out.shape[0],
                      "span": min(n, (out.shape[0] - 1) * int(hop * sr) + sr),  # the PCM its windows cover
                      "latency_s": t_c - t_a, "enqueue_s": t_b - t_a,
                      "traced": trace_from <= i < trace_to})

    k = 0
    while time.perf_counter() < t_stop:
        if k == trace_from:
            while pending:
                collect()
            _sync(device)
            prof = profile(activities=activities)
            prof.start()
            span = record_function(traces.STRETCH)
            span.__enter__()
            tracing = True
        audio = stream.clip(k_warm + k)
        t_a = time.perf_counter()
        with record_function("extract.enqueue"):
            h = ext.embed_audio_async(audio, hop)
        pending.append((k, k_warm + k, h, t_a, time.perf_counter()))
        k += 1
        while len(pending) >= depth:
            collect()
        if k == trace_to:
            while pending:
                collect()
            _sync(device)
            span.__exit__(None, None, None)
            prof.stop()
            tracing = False
    while pending:
        collect()
    t_end = time.perf_counter()
    if tracing:  # the window closed inside the stretch
        _sync(device)
        span.__exit__(None, None, None)
        prof.stop()

    record = {
        "setup_s": setup_s,
        "setup_phases": phases,
        "window_s": t_end - t_start,
        "attempted": k,
        # A clip that never returned, or returned a row that is not finite.
        "failed": k - len(clips) + sum(check.nonfinite(rows[c["k"]]) for c in clips),
        "clips": clips,
        "windows": sum(c["rows"] for c in clips),
        "trace": None,
    }
    if torch.device(device).type == "cuda":
        record["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    if prof is not None:
        record["trace"] = traces.reduce(prof)
        record["trace_clips"] = [c for c in clips if c["traced"]]
        del prof
    del ext
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    record["numbers"] = _check(ctx, params, stream, rows, clips, sr, hop)
    return record


def _sample(ctx, clips: list) -> list:
    """A seeded sample of `check.sample` clips of the window, with the
    longest and the shortest among them."""
    want = int(ctx.cell["check"]["sample"])
    rng = np.random.default_rng([int(ctx.seed), 7])
    keys = [c["k"] for c in clips]
    if not keys:
        return []
    by_len = sorted(clips, key=lambda c: c["samples"])
    chosen = {by_len[0]["k"], by_len[-1]["k"]}
    for i in rng.permutation(len(keys)):
        if len(chosen) >= want:
            break
        chosen.add(keys[i])
    return sorted(chosen)


def reference_rows(params, stream, k, cfg, pooling, hop, device, prec) -> np.ndarray:
    """The reference's rows of clip k, in blocks of 64 windows."""
    win = ref.frame_windows(stream.clip(k), cfg["sr"], hop)
    out = []
    with torch.no_grad():
        for i in range(0, len(win), 64):
            x = torch.from_numpy(win[i:i + 64]).to(device)
            out.append(ref.audio_embedding(params, x, cfg, pooling, prec).cpu().numpy())
    return np.concatenate(out)


def int8_extractor(params, stream, cfg, pooling, hop, device):
    """The program's own int8 path (``QuantizedEmbeddingExtractor``, the
    ``05 --int8`` route) on the harness's weights, calibrated on the first
    two clips of the stream: the control of a bf16 extraction cell."""
    from l3embedding_torch.compat.to_jax import avc_to_jax_variables
    from l3embedding_torch.embed.extract import frame_uniform
    from l3embedding_torch.embed.quantized import QuantizedEmbeddingExtractor
    from l3embedding_torch.models.registry import build_model

    model = build_model(cfg["model_type"]).module()
    _port.load(model.audio_model, params, TOWER)
    variables = avc_to_jax_variables(model, cfg["model_type"])
    q = QuantizedEmbeddingExtractor(None, cfg["model_type"], pooling, variables=variables,
                                    device_framing=True, device=device)
    q.q.calibrate(np.concatenate([frame_uniform(stream.clip(k), cfg["sr"], hop) for k in range(2)]))
    return q


def _check(ctx, params, stream, rows, clips, sr, hop) -> dict:
    cfg, pooling = ctx.config, ctx.cell["options"]["pooling"]
    bad = sum(c["rows"] != _windows(c["samples"], sr, hop) for c in clips)
    sample = _sample(ctx, clips)
    errs, control_errs = [], {p: [] for p in ctx.controls}
    q8 = int8_extractor(params, stream, cfg, pooling, hop, ctx.device) if "int8prog" in ctx.controls else None
    for k in sample:
        want = reference_rows(params, stream, k, cfg, pooling, hop, ctx.device, "f32")
        errs.append(check.row_errs(rows[k], want))
        for prec in ctx.controls:
            got = (q8.embed_audio(stream.clip(k), hop) if prec == "int8prog"
                   else reference_rows(params, stream, k, cfg, pooling, hop, ctx.device, prec))
            control_errs[prec].append(check.row_errs(got, want))

    def numbers(e, bad_counts):
        flat = np.concatenate(e) if e else np.zeros(0)
        return {"bad_counts": bad_counts, "row_err": float(flat.max()) if flat.size else 0.0,
                "clip_err": check.clip_err(e), "clip_p90": check.clip_p90(e), "clip_mean": check.clip_mean(e),
                "row_err_median": float(np.median(flat)) if flat.size else 0.0, "checked_rows": int(flat.size)}

    out = numbers(errs, bad)
    if ctx.controls:
        out["controls"] = {p: numbers(e, 0) for p, e in control_errs.items()}
    return out
