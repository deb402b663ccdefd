"""In-process embedding service with request micro-batching (port of
``l3embedding_tpu/embed/service.py``).

`EmbeddingService` accepts concurrent single-clip (or multi-clip)
requests from any number of threads, coalesces them into device batches
(up to max_batch_size, waiting at most max_latency_ms for stragglers),
runs the resident extractor, and scatters results back to the callers'
futures. The extractor's power-of-two buckets bound the batch shapes
whatever the arrival pattern.

The execution path is pipelined: a dispatcher thread coalesces requests
and *dispatches* each device batch without waiting for its results
(``EmbeddingExtractor.embed_windows_async`` uploads from pinned memory,
launches on the extractor's stream and returns an ``EmbeddingRows``
handle whose rows copy back into a pinned host tensor behind a CUDA
event), and a collector thread waits on each batch's events
(``EmbeddingRows.result()``, not a device-wide synchronise) and resolves
futures in dispatch order. With `pipeline_depth` batches in flight the
card computes batch k+1 while batch k's rows copy back; each in-flight
batch owns its pinned result buffer until it is collected. Extractors
without an async path (duck-typed stand-ins) degrade to synchronous
dispatch with unchanged semantics, and a handle without ``result()`` is
materialised with ``np.asarray``.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future

import numpy as np

from .extract import EmbeddingExtractor

_SENTINEL = object()


def _materialize(handle) -> np.ndarray:
    """The rows of an extractor's (async) result: ``result()`` of an
    EmbeddingRows handle, else ``np.asarray`` (arrays, duck-typed handles)."""
    result = getattr(handle, "result", None)
    return result() if result is not None else np.asarray(handle)


class EmbeddingService:
    def __init__(
        self,
        extractor: EmbeddingExtractor,
        max_batch_size: int = 128,
        max_latency_ms: float = 5.0,
        pipeline_depth: int = 2,
    ):
        """pipeline_depth: max device batches in flight (dispatched but
        not yet collected). 1 = fully synchronous (batch k+1 waits for
        batch k's readback); 2+ overlaps readback with compute. Each
        in-flight batch holds its own pinned result buffer on the host."""
        self.extractor = extractor
        self.max_batch_size = max_batch_size
        self.max_latency = max_latency_ms / 1000.0
        self.pipeline_depth = max(1, int(pipeline_depth))
        # Observability (read by stats_snapshot / http_serve /statz):
        # counters are written single-writer (submit under the lock,
        # batch counters in the dispatcher/collector threads only).
        self._n_requests = 0
        self._n_windows = 0
        self._n_batches = 0
        self._n_errors = 0
        # Host-clock seconds, summed over device batches: coalescing (first
        # request taken → batch closed), dispatch (concatenate, upload,
        # launch) and collection (waiting for the rows to land on the host).
        self._coalesce_s = 0.0
        self._dispatch_s = 0.0
        self._collect_s = 0.0
        from collections import deque

        self._recent_batches = deque(maxlen=512)  # coalesced sizes
        self._recent_latency = deque(maxlen=2048)  # submit→resolve secs
        self._started = time.time()
        self._q: queue.Queue = queue.Queue()
        # Dispatched-but-uncollected batches; the bounded size is the
        # pipeline's backpressure (a full queue stalls the dispatcher,
        # not the device).
        self._results: queue.Queue = queue.Queue(maxsize=self.pipeline_depth)
        self._stop = threading.Event()
        # Serializes the stop-check+enqueue in submit() against close()
        # setting the flag: without it a thread could pass the check,
        # close() could set+drain, and the late put would enqueue a
        # future nobody ever resolves (its caller blocks forever in
        # Future.result()).
        self._submit_lock = threading.Lock()
        self._worker = threading.Thread(target=self._dispatch_loop,
                                        daemon=True)
        self._collector = threading.Thread(target=self._collect_loop,
                                           daemon=True)
        self._worker.start()
        self._collector.start()

    def submit(self, windows: np.ndarray) -> Future:
        """(N, 48000) float32 windows → Future[(N, dim) embeddings]."""
        windows = np.ascontiguousarray(windows, dtype=np.float32)
        if windows.ndim == 1:
            windows = windows[None, :]
        fut: Future = Future()
        fut._l3_t0 = time.perf_counter()  # for /statz latency percentiles
        with self._submit_lock:
            if self._stop.is_set():
                fut.set_exception(RuntimeError("EmbeddingService is closed"))
                return fut
            self._n_requests += 1
            self._n_windows += windows.shape[0]
            self._q.put((windows, fut))
        return fut

    def embed(self, windows: np.ndarray) -> np.ndarray:
        return self.submit(windows).result()

    def _dispatch_loop(self):
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            count = first[0].shape[0]
            deadline = self.max_latency
            t0 = time.perf_counter()
            while count < self.max_batch_size:
                remaining = deadline - (time.perf_counter() - t0)
                if remaining <= 0:
                    break
                try:
                    item = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                batch.append(item)
                count += item[0].shape[0]
            t1 = time.perf_counter()
            self._coalesce_s += t1 - t0

            try:
                # Inside the try: clients submitting mismatched window
                # widths into one coalescing interval make this raise —
                # that must fail THIS batch's futures, not kill the
                # dispatcher thread (which would strand every future
                # ever submitted afterwards).
                windows = np.concatenate([w for w, _ in batch])
                # Async dispatch: the returned handle materialises in the
                # collector (_materialize). Stand-in extractors without the
                # async method run synchronously here. Resolved per batch:
                # tests swap self.extractor at runtime.
                embed_async = getattr(self.extractor, "embed_windows_async",
                                      None)
                emb = (embed_async(windows) if embed_async is not None
                       else self.extractor.embed_windows(windows))
                self._dispatch_s += time.perf_counter() - t1
            except Exception as e:  # pragma: no cover
                self._n_errors += 1
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)
                    self._q.task_done()
                continue
            self._n_batches += 1
            self._recent_batches.append(count)
            # Bounded put: with pipeline_depth batches awaiting
            # collection this blocks, stalling coalescing rather than
            # piling uncollected results onto the device. Bounded waits
            # so a wedged collector can't trap the dispatcher past
            # close() (the batch is failed loudly instead).
            while True:
                try:
                    self._results.put((emb, batch), timeout=0.5)
                    break
                except queue.Full:
                    if self._stop.is_set():
                        err = RuntimeError(
                            "EmbeddingService closed with the result "
                            "collector stalled; request not served"
                        )
                        for _, fut in batch:
                            if not fut.done():
                                fut.set_exception(err)
                            self._q.task_done()
                        break

    def _collect_loop(self):
        while True:
            item = self._results.get()
            if item is _SENTINEL:
                return
            emb, batch = item
            try:
                t0 = time.perf_counter()
                arr = _materialize(emb)
                now = time.perf_counter()
                self._collect_s += now - t0
                start = 0
                for w, fut in batch:
                    # done() guard: a caller may have cancel()ed its
                    # future while the batch was in flight; set_result
                    # on it raises InvalidStateError, which would trip
                    # the batch-wide except and poison every LATER
                    # request coalesced into this batch. Mirror the
                    # dispatcher's error-path guard.
                    if not fut.done():
                        fut.set_result(arr[start : start + w.shape[0]])
                        t0 = getattr(fut, "_l3_t0", None)
                        if t0 is not None:
                            self._recent_latency.append(now - t0)
                    start += w.shape[0]
            except Exception as e:  # pragma: no cover
                self._n_errors += 1
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)
            finally:
                for _ in batch:
                    self._q.task_done()

    def stats_snapshot(self) -> dict:
        """Point-in-time observability summary (http_serve /statz).

        Latency percentiles are submit→resolve over the last ≤2048
        requests; coalesced-batch stats over the last ≤512 device
        batches. The ``*_ms_total`` counters sum, over every device batch,
        the host-clock time spent coalescing it, dispatching it and
        waiting for its rows. Cheap enough to poll: deque copies, no locks
        on the hot path."""
        lat = sorted(self._recent_latency)
        sizes = list(self._recent_batches)

        def pct(p):
            if not lat:
                return None
            return round(lat[min(len(lat) - 1, int(p / 100 * len(lat)))]
                         * 1e3, 3)

        return {
            "uptime_sec": round(time.time() - self._started, 1),
            "requests": self._n_requests,
            "windows": self._n_windows,
            "device_batches": self._n_batches,
            "errors": self._n_errors,
            "queue_depth": self._q.qsize(),
            "inflight_batches": self._results.qsize(),
            "pipeline_depth": self.pipeline_depth,
            "max_batch_size": self.max_batch_size,
            "max_latency_ms": self.max_latency * 1e3,
            "mean_coalesced_batch": (round(float(np.mean(sizes)), 2)
                                     if sizes else None),
            "max_coalesced_batch": max(sizes) if sizes else None,
            "latency_ms_p50": pct(50),
            "latency_ms_p95": pct(95),
            "latency_ms_p99": pct(99),
            "coalesce_ms_total": round(self._coalesce_s * 1e3, 3),
            "dispatch_ms_total": round(self._dispatch_s * 1e3, 3),
            "collect_ms_total": round(self._collect_s * 1e3, 3),
            "closed": self._stop.is_set(),
        }

    def drain(self, timeout: float = 10.0) -> bool:
        """Wait (bounded) until every accepted request has RESOLVED —
        the graceful half of a SIGTERM shutdown. Exact, not racy: the
        queue's task_done accounting is only advanced after a request's
        future is set. Returns False if the timeout expired with work
        still pending (close() then fails the leftovers loudly)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._q.unfinished_tasks == 0:
                return True
            time.sleep(0.02)
        return False

    def close(self):
        with self._submit_lock:
            # Under the lock: every submit() has either fully enqueued
            # (drained below) or will observe the flag and fail fast.
            self._stop.set()
        self._worker.join(timeout=10)
        try:
            # Non-blocking: if the bounded queue is full the collector is
            # wedged — don't let close() block on it (the drain below
            # fails the stranded batches; the daemon thread dies with the
            # process).
            self._results.put_nowait(_SENTINEL)
        except queue.Full:
            pass
        self._collector.join(timeout=10)
        # Fail any dispatched-but-uncollected batches (possible only if
        # the collector died or timed out above).
        while True:
            try:
                item = self._results.get_nowait()
            except queue.Empty:
                break
            if item is _SENTINEL:
                continue
            _, batch = item
            for _, fut in batch:
                if not fut.done():
                    fut.set_exception(
                        RuntimeError("EmbeddingService closed before "
                                     "serving this request")
                    )
        # Fail any requests still queued (enqueued just before close, or
        # orphaned by a dead worker): their callers are blocked in
        # Future.result() and would otherwise hang forever.
        while True:
            try:
                _, fut = self._q.get_nowait()
            except queue.Empty:
                break
            if not fut.done():
                fut.set_exception(
                    RuntimeError("EmbeddingService closed before serving "
                                 "this request")
                )

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
