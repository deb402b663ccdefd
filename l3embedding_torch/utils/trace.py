"""Spans and counters inside the program, recorded only while a
``torch.profiler`` records.

    with trace.span("extract.call", stream_or_device, rows=n):
        ...

Tracing is on exactly while ``torch.autograd._profiler_enabled()`` is true,
the flag that ``record_function`` itself reads: a ``torch.profiler.profile``
turns it on (the benchmark's traced stretch, ``03 --profile-steps N``), and
nothing else does. Off, a span site costs that one flag call: ``span``
hands back a shared do-nothing context, and no ``record_function``, CUDA
event or tensor hook is made and nothing is kept.

On, a span opens a ``record_function`` of its name (so it sits in the
profiler's timeline beside the device's kernels) and keeps its name, its
parent (the innermost span open on its thread), its host start and end
(``time.perf_counter_ns``) and its counters, in a buffer of the last
CAPACITY closed spans (``spans()``, ``clear()``). A span given a stream or
a CUDA device (`at`) also records a timing CUDA event there at enter and
exit, and its device time (``device_s``) is the time between them; any
other span's is its host time. Only spans whose device time something reads
take `at`: the events cost host time under the profiler.

A span is not opened inside an open span of the same name on its thread, so
a public call that calls another (``embed_audio_async`` →
``embed_windows_async``) is one span. ``backward_span`` marks the backward
of a stretch of the forward by two tensor hooks.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time

import torch
from torch.autograd.profiler import record_function

CAPACITY = 65536

on = torch.autograd._profiler_enabled  # tracing is on while a torch.profiler records

_NULL = contextlib.nullcontext()  # a span site's context while tracing is off
_done: collections.deque = collections.deque(maxlen=CAPACITY)
_ids = itertools.count(1)
_local = threading.local()


def _stack() -> list:
    """The open spans of this thread, innermost last."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class Span:
    """One span: `name`, `id`, `parent` (the id of the span it ran in, or
    None), `start_ns` / `end_ns` on the host, `counters`, and `device_s`
    once ``spans()`` has resolved it. A context manager on one thread
    (``span``), or begun and ended by hooks (``backward_span``)."""

    __slots__ = ("name", "id", "parent", "start_ns", "end_ns", "counters", "device_s", "_at", "_events", "_rf")

    def __init__(self, name: str, parent: int | None, counters: dict, at=None):
        self.name, self.id, self.parent, self.counters = name, next(_ids), parent, counters
        if at is not None and not isinstance(at, torch.cuda.Stream):
            at = torch.device(at)
            at = torch.cuda.current_stream(at) if at.type == "cuda" else None
        self._at = at
        self.start_ns = self.end_ns = self.device_s = self._events = self._rf = None

    def _begin(self) -> None:
        self._rf = record_function(self.name)
        self._rf.__enter__()
        if self._at is not None:
            self._events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            self._events[0].record(self._at)
        self.start_ns = time.perf_counter_ns()

    def _end(self) -> None:
        self.end_ns = time.perf_counter_ns()
        if self._events is not None:
            self._events[1].record(self._at)
        self._rf.__exit__(None, None, None)
        self._rf = None
        _done.append(self)

    def __enter__(self):
        self._begin()
        _stack().append(self)
        return self

    def __exit__(self, *exc):
        _stack().pop()
        self._end()
        return False

    def _resolve(self) -> None:
        if self.device_s is not None:
            return
        if self._events is None:
            self.device_s = (self.end_ns - self.start_ns) / 1e9
        else:
            self._events[1].synchronize()
            self.device_s = self._events[0].elapsed_time(self._events[1]) / 1e3
            self._events = None


def span(name: str, at=None, **counters):
    """A context that records span `name` while tracing is on. `at`: the
    CUDA stream the span's work goes to, or its device (its current
    stream), for a device time; None or a CPU device: host time only."""
    if not on():
        return _NULL
    stack = _stack()
    if any(s.name == name for s in stack):
        return _NULL
    return Span(name, stack[-1].id if stack else None, counters, at)


def count(name: str, **counters) -> None:
    """Add `counters` to the innermost open span `name` of this thread."""
    if not on():
        return
    for s in reversed(_stack()):
        if s.name == name:
            for k, v in counters.items():
                s.counters[k] = s.counters.get(k, 0) + v
            return


def backward_span(name: str, output: torch.Tensor, end: torch.Tensor | None) -> None:
    """While tracing is on, mark the backward of the forward stretch from
    `end` to `output` as span `name`, timed on the device: a hook on
    `output` opens it when output's gradient is ready, a hook on `end`
    closes it when end's gradient is complete, both on the current stream
    of the thread that runs the backward. Its parent is the innermost span
    open, when the backward reaches `output`, on the thread that made this
    call (the one that called ``backward()``)."""
    if not on() or end is None or not (output.requires_grad and end.requires_grad):
        return
    stack = _stack()
    opened = []

    def begin(grad):
        s = Span(name, stack[-1].id if stack else None, {}, grad.device)
        s._begin()
        opened.append(s)

    def finish(grad):
        if opened:
            opened.pop()._end()

    output.register_hook(begin)
    end.register_hook(finish)


def spans() -> list[Span]:
    """The closed spans in the buffer, oldest first, each with its device
    time resolved."""
    out = list(_done)
    for s in out:
        s._resolve()
    return out


def last(name: str, n: int, among: list[Span] | None = None) -> list[Span] | None:
    """The last `n` top-level spans `name` (of `among`, else of ``spans()``),
    or None if there are fewer."""
    roots = [s for s in (spans() if among is None else among) if s.name == name and s.parent is None][-n:]
    return roots if n > 0 and len(roots) == n else None


def share(child: str, root: str, n: int) -> float | None:
    """The share, in %, of the device time of the last `n` top-level spans
    `root` that the spans `child` below them take; None if there are fewer
    than `n` such roots or they took no time."""
    every = spans()
    roots = last(root, n, every)
    if roots is None:
        return None
    ids = {s.id for s in roots}
    parent = {s.id: s.parent for s in every}

    def under(s):
        p = s.parent
        while p is not None and p not in ids:
            p = parent.get(p)
        return p is not None

    total = sum(s.device_s for s in roots)
    part = sum(s.device_s for s in every if s.name == child and under(s))
    return 100.0 * part / total if total > 0 else None


def clear() -> None:
    _done.clear()
