"""Reduction of a profiler trace to what the metric readers take.

A traced run wraps one short stretch of its window in the span
``bench.traced`` (``torch.profiler.record_function``). Within that span:

* busy time is the union of the intervals of the device's own events
  (kernels, copies, sets); the device-side ranges of user annotations span
  their kernels and the gaps between them, so they are left out;
* each device operation's time is summed by name;
* each idle gap on the device is named by what the host was doing at its
  middle: the innermost harness span (``extract.*``, ``train.*``) and the
  innermost host operation on the thread that opened the stretch.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

import torch

STRETCH = "bench.traced"
HARNESS_PREFIXES = ("extract.", "train.")
LABELLED_GAPS = 400  # the longest gaps that get a host label


def _is_device(e) -> bool:
    return e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False)


def _innermost(events, starts, t, pick=lambda e: True):
    """The latest-starting event of `events` (sorted by start) that holds t."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 20000), -1):
        e = events[j]
        if e.time_range.end >= t and pick(e):
            return e
    return None


def reduce(prof) -> dict | None:
    """{"stretch_s", "busy_s", "ops": {name: seconds}, "calls": {name:
    count}, "gaps": [(label, seconds, count)] by total, "n_device_events"};
    None when the trace holds no stretch."""
    events = list(prof.events())
    spans = [e for e in events if e.name == STRETCH and e.device_type == torch.autograd.DeviceType.CPU]
    if not spans:
        return None
    span = spans[0]
    t0, t1 = span.time_range.start, span.time_range.end
    intervals = []
    ops: dict = defaultdict(float)
    calls: dict = defaultdict(int)
    for e in events:
        if not _is_device(e):
            continue
        s, f = max(e.time_range.start, t0), min(e.time_range.end, t1)
        if f > s:
            intervals.append((s, f))
            ops[e.name] += (f - s) / 1e6
            calls[e.name] += 1
    intervals.sort()
    busy, end, gaps = 0.0, t0, []
    for s, f in intervals:
        if s > end:
            gaps.append((end, s))
        if f > end:
            busy += f - max(s, end)
            end = f
    if t1 > end:
        gaps.append((end, t1))

    host = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CPU
                   and e.thread == span.thread and e is not span), key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in host]
    labelled: dict = defaultdict(lambda: [0.0, 0])
    ordered = sorted(gaps, key=lambda g: g[1] - g[0], reverse=True)
    for s, f in ordered[:LABELLED_GAPS]:
        mid = (s + f) / 2
        harness = _innermost(host, starts, mid, lambda e: e.name.startswith(HARNESS_PREFIXES))
        op = _innermost(host, starts, mid, lambda e: not e.name.startswith(HARNESS_PREFIXES))
        label = "/".join(x.name for x in (harness, op) if x is not None) or "host: no span"
        labelled[label][0] += (f - s) / 1e6
        labelled[label][1] += 1
    if len(ordered) > LABELLED_GAPS:
        labelled["shorter gaps"] = [sum(f - s for s, f in ordered[LABELLED_GAPS:]) / 1e6,
                                    len(ordered) - LABELLED_GAPS]
    return {
        "stretch_s": (t1 - t0) / 1e6,
        "busy_s": busy / 1e6,
        "ops": dict(ops),
        "calls": dict(calls),
        "gaps": sorted(((k, v[0], v[1]) for k, v in labelled.items()), key=lambda g: g[1], reverse=True),
        "n_device_events": len(intervals),
    }


def merge(traces: list[dict]) -> dict:
    """One reduction a rank → their mean: stretch, busy, each op's seconds
    and calls and each gap's seconds averaged over the ranks."""
    n = len(traces)
    ops: dict = defaultdict(float)
    calls: dict = defaultdict(float)
    gaps: dict = defaultdict(lambda: [0.0, 0])
    for t in traces:
        for k, v in t["ops"].items():
            ops[k] += v / n
        for k, v in t["calls"].items():
            calls[k] += v / n
        for label, s, count in t["gaps"]:
            gaps[label][0] += s / n
            gaps[label][1] += count
    return {
        "stretch_s": sum(t["stretch_s"] for t in traces) / n,
        "busy_s": sum(t["busy_s"] for t in traces) / n,
        "ops": dict(ops),
        "calls": dict(calls),
        "gaps": sorted(((k, v[0], v[1]) for k, v in gaps.items()), key=lambda g: g[1], reverse=True),
        "n_device_events": sum(t["n_device_events"] for t in traces),
    }


def breakdown(trace: dict, top: int = 10) -> dict:
    """The result line's breakdown: the device operations that took most
    time and the idle gaps by what the host was doing, seconds unrounded."""
    ops = sorted(trace["ops"].items(), key=lambda kv: kv[1], reverse=True)[:top]
    return {
        "device_ops": [[name, s] for name, s in ops],
        "idle_gaps": [[f"{label} ({count} gaps)", s] for label, s, count in trace["gaps"][:top]],
    }
