"""Driver of the Whisper encoder cell: ``WhisperExtractor.embed_windows_async``
in the closed loop of a long-form corpus pass (``05 --features whisper``).

Each clip of the mix is cut into non-overlapping 30 s windows (the last
zero-padded, as the program's ``frame_whisper`` cuts them), and the windows
of consecutive clips are packed ``windows_per_call`` to a call, as a corpus
pass that keeps the card's batch full does; up to ``depth`` calls are in flight and
the oldest's rows are taken once that many are pending. The window's rate
counts the windows returned, over the time from the first dispatch to the
last rows: once the time is up nothing more is sent and every call in
flight is waited for. Set-up runs the loop in groups of calls for at least
``warmup_s`` seconds and until a group's time is steady, so that every
call's shape has run and the card's clock has settled under the load (the
encoder's GEMMs hold the card at its power limit). The cards' clocks,
power and temperature before and after the window go to standard error. A
traced run drains the loop, traces ``trace.units`` calls from call
``trace.start``, and drains again.

The check: a seeded sample of ``check.sample`` windows of the window's
calls (a reservoir over every window returned) keep their rows, and once
the window has closed and the program is freed, the plain reference
recomputes each from its clip's PCM. Every returned window's rows are
checked for their shape and for values that are not finite as they come:
a window's sum over its rows is finite just when its values are (they are
LayerNorm outputs, far from float32's overflow), and one reduction costs
the host less than a test of every value.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from .. import check, generate, traces
from ..context import resolve
from ..reference import whisper as ref
from .train import _gpus


def _sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Packer:
    """The mix's clips from clip k0 on, cut into non-overlapping n-sample
    windows (the last of a clip zero-padded) and packed `per_call` windows a
    call into one reused buffer; ``next()`` → (windows (per_call, n) float32,
    their pad samples, [(clip, window of the clip)]). The buffer is written
    again by the next ``next()``: the program copies a call's windows into
    its staging before the call returns."""

    def __init__(self, stream, n: int, per_call: int, k0: int = 0):
        self.stream, self.n = stream, n
        self.k, self._j = k0, 0
        self._buf = np.empty((per_call, n), np.float32)

    def next(self):
        ids, pad = [], 0
        for row in self._buf:
            clip = self.stream.clip(self.k)
            part = clip[self._j * self.n:(self._j + 1) * self.n]
            row[:len(part)] = part
            row[len(part):] = 0.0
            pad += self.n - len(part)
            ids.append((self.k, self._j))
            self._j += 1
            if self._j * self.n >= len(clip):
                self.k, self._j = self.k + 1, 0
        return self._buf, pad, ids


GROUP_CALLS = 4  # warm-up calls a timing group
STEADY = 0.01  # warm-up ends once a group's time is within this share of the last one's


def _drain_loop(ext, packer, depth: int, calls: int) -> None:
    """The closed loop, untimed, for `calls` calls, drained at the end."""
    pending = deque()
    for _ in range(calls):
        windows, pad, _ = packer.next()
        pending.append(ext.embed_windows_async(windows, pad))
        while len(pending) >= depth:
            pending.popleft().result()
    while pending:
        pending.popleft().result()


def _warm_up(ext, packer, depth: int, seconds: float) -> list[float]:
    """The loop in groups of GROUP_CALLS calls, for at least `seconds` and
    until a group's time is within STEADY of the last one's (at most 3 x
    `seconds`), so that the card's clocks have settled under the load; →
    the groups' times."""
    times, t0 = [], time.perf_counter()
    while True:
        t = time.perf_counter()
        _drain_loop(ext, packer, depth, GROUP_CALLS)
        times.append(time.perf_counter() - t)
        elapsed = time.perf_counter() - t0
        steady = len(times) > 1 and abs(times[-1] - times[-2]) <= STEADY * times[-2]
        if (elapsed >= seconds and steady) or elapsed >= 3 * seconds:
            return times


def dims(cfg: dict):
    from l3embedding_torch.models.whisper_encoder import WhisperDims

    return WhisperDims(n_mels=cfg["n_mels"], n_audio_ctx=cfg["n_audio_ctx"], n_audio_state=cfg["n_audio_state"],
                       n_audio_head=cfg["n_audio_head"], n_audio_layer=cfg["n_audio_layer"])


def run(ctx) -> dict:
    from l3embedding_torch.embed.whisper import WhisperExtractor

    cell, cfg, mix, device = ctx.cell, ctx.config, ctx.mix, ctx.device
    cuda = torch.device(device).type == "cuda"
    phases = [*ctx.marks, ("imports", time.time() - ctx.t0)]
    n = cfg["n_samples"]
    per_call, depth = int(mix["windows_per_call"]), int(mix["depth"])
    params = ref.make_weights(cfg, ctx.seed, device)
    ext = WhisperExtractor(params, fast=cell["precision"] == "bf16", device=device, dims=dims(cfg))
    del params  # made again from the seed for the reference, after the window
    phases.append(("CUDA context, weights and extractor", time.time() - ctx.t0))
    stream = generate.generator(mix).ClipStream(mix, ctx.seed, device, cfg["sr"])
    phases.append(("traffic", time.time() - ctx.t0))

    # Warm-up: full calls (the loop's one shape) at the loop's depth, so
    # that the pinned buffers of the calls in flight exist and the card's
    # clocks have settled before the window.
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    warm = Packer(stream, n, per_call)
    times = _warm_up(ext, warm, depth, float(cell["warmup_s"]))
    phases.append((f"warm-up, {len(times) * GROUP_CALLS} calls, groups of {GROUP_CALLS} in "
                   + " ".join(f"{t:.3f}" for t in times) + " s", time.time() - ctx.t0))
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if ctx.trace:  # the profiler's own first start, outside the window
        with profile(activities=activities):
            ext.embed_windows_async(*warm.next()[:2]).result()
    _sync(device)
    setup_s = time.time() - ctx.t0
    phases.append(("profiler's first start" if ctx.trace else "synchronised", setup_s))
    gpus_before = _gpus() if cuda else ""
    if ctx.plant:  # the tests' faults break the timed path from the window's first call
        resolve(ctx.plant)(ext)

    shape = (dims(cfg).n_audio_ctx, dims(cfg).n_audio_state)
    want = int(cell["check"]["sample"])
    rng = np.random.default_rng([int(ctx.seed), 7])
    kept, seen = {}, [0]  # reservoir: sampled (clip, window) → rows
    tr = cell["trace"]
    trace_from, trace_to = (tr["start"], tr["start"] + tr["units"]) if ctx.trace else (-1, -1)
    packer = Packer(stream, n, per_call, warm.k)
    pending, stats = deque(), {"windows": 0, "bad": 0, "nonfinite": 0, "traced": 0}
    prof = span = None
    tracing = False

    def collect():
        i, h, ids = pending.popleft()
        with record_function("extract.collect"):
            rows = h.result()
        stats["windows"] += len(ids)
        stats["traced"] += trace_from <= i < trace_to
        if rows.shape != (len(ids), *shape):
            stats["bad"] += len(ids)
            return
        finite = np.isfinite(torch.from_numpy(rows).sum(dim=(1, 2)).numpy())
        stats["nonfinite"] += int((~finite).sum())
        stats["bad"] += int((~finite).sum())
        for j, wid in enumerate(ids):
            t = seen[0]
            seen[0] += 1
            if len(kept) < want:
                kept[wid] = rows[j].copy()
            elif (r := int(rng.integers(0, t + 1))) < want:
                del kept[list(kept)[r]]
                kept[wid] = rows[j].copy()

    t_start = time.perf_counter()
    t_stop = t_start + ctx.seconds
    i = attempted = 0
    while time.perf_counter() < t_stop:
        if i == trace_from:
            while pending:
                collect()
            _sync(device)
            prof = profile(activities=activities)
            prof.start()
            span = record_function(traces.STRETCH)
            span.__enter__()
            tracing = True
        windows, pad, ids = packer.next()
        with record_function("extract.enqueue"):
            h = ext.embed_windows_async(windows, pad)
        pending.append((i, h, ids))
        attempted += len(ids)
        i += 1
        while len(pending) >= depth:
            collect()
        if i == trace_to:
            while pending:
                collect()
            _sync(device)
            span.__exit__(None, None, None)
            prof.stop()
            tracing = False
    while pending:
        collect()
    t_end = time.perf_counter()
    gpus_after = _gpus() if cuda else ""
    if tracing:  # the window closed inside the stretch
        _sync(device)
        span.__exit__(None, None, None)
        prof.stop()

    record = {
        "setup_s": setup_s,
        "setup_phases": phases,
        "window_s": t_end - t_start,
        "attempted": attempted,
        # A window that never returned, or returned a value that is not finite.
        "failed": attempted - stats["windows"] + stats["nonfinite"],
        "windows": stats["windows"],
        "trace": None,
        "trace_calls": stats["traced"],
        "gpus": {"before": gpus_before, "after": gpus_after} if cuda else None,
    }
    if cuda:
        record["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    if prof is not None:
        record["trace"] = traces.reduce(prof)
        del prof
    del ext
    if cuda:
        torch.cuda.empty_cache()
    record["numbers"] = _check(ctx, stream, kept, stats["bad"], n)
    return record


def _check(ctx, stream, kept: dict, bad: int, n: int) -> dict:
    """The numbers compared: each sampled window's per-frame errors
    |p − r| / |r| against the reference, and the windows misshapen or not
    finite; the controls' numbers beside them."""
    cfg = ctx.config
    params = ref.make_weights(cfg, ctx.seed, ctx.device)
    errs, control_errs = [], {p: [] for p in ctx.controls}
    for (k, j), rows in sorted(kept.items()):
        pcm = torch.from_numpy(ref.window(stream.clip(k), j, n)[None]).to(ctx.device)
        want = ref.embed(params, pcm, cfg)[0].cpu().numpy()
        errs.append(check.row_errs(rows, want))
        for prec in ctx.controls:
            control_errs[prec].append(check.row_errs(ref.embed(params, pcm, cfg, prec)[0].cpu().numpy(), want))

    def numbers(e, bad_windows):
        flat = np.concatenate(e) if e else np.zeros(0)
        return {"bad_windows": bad_windows, "window_err": check.clip_err(e), "window_p90": check.clip_p90(e),
                "frame_err": float(flat.max()) if flat.size else 0.0,
                "frame_err_median": float(np.median(flat)) if flat.size else 0.0,
                "checked_windows": len(e)}

    out = numbers(errs, bad)
    if ctx.controls:
        out["controls"] = {p: numbers(e, 0) for p, e in control_errs.items()}
    return out
