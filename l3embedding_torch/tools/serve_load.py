"""Closed-loop load on an EmbeddingService: N client threads, each sending
its next request as soon as the last one resolved, for a fixed window of
time and until the run has completed at least a given number of
requests. Reports submit→resolve latency percentiles (each only where at
least MIN_TAIL samples lie beyond it), the aggregate clip rate, the mean
coalesced batch and the service's mean host time per device batch spent
coalescing, dispatching and collecting (its own counters over the run).

    from l3embedding_torch.tools.serve_load import closed_loop
    stats = closed_loop(service, n_clients=16, payloads=windows, seconds=4.0, min_requests=1000)
"""

from __future__ import annotations

import itertools
import threading
import time

import numpy as np

MIN_TAIL = 10  # samples a percentile needs beyond it to be reported


def percentile(lat_ms: np.ndarray, p: float) -> float | None:
    """The p-th percentile of the samples, or None where fewer than
    MIN_TAIL of them lie beyond it."""
    if lat_ms.size * (100 - p) / 100 < MIN_TAIL:
        return None
    return float(np.percentile(lat_ms, p))


def closed_loop(service, n_clients: int, payloads, seconds: float, min_requests: int = 0,
                timeout: float = 600.0) -> dict:
    """Each client sends requests until `seconds` have passed and the run
    has completed `min_requests`; request i of client c is
    ``payloads[(c + i) % len(payloads)]`` ((k, 48000) windows, or one
    (48000,) window). Returns a dict of p50/p95/p99 ms (None where the run
    has fewer than MIN_TAIL samples beyond), clips/s over the wall time of
    the whole run, requests, device batches, the mean coalesced batch in
    windows, the mean coalescing, dispatch and collection ms per device
    batch, and every client's first rows (``first``) for checking against
    the direct path."""
    payloads = [np.ascontiguousarray(p, dtype=np.float32) for p in payloads]
    latencies = [[] for _ in range(n_clients)]
    first = [None] * n_clients
    errors = []
    done = itertools.count(1)
    completed = [0]
    start = threading.Barrier(n_clients + 1)
    deadline = [0.0]

    def client(c):
        start.wait()
        for i in itertools.count():
            if time.perf_counter() >= deadline[0] and completed[0] >= min_requests:
                return
            t0 = time.perf_counter()
            try:
                rows = service.submit(payloads[(c + i) % len(payloads)]).result(timeout=timeout)
            except Exception as e:  # reported below, after every client ended
                errors.append(repr(e))
                return
            latencies[c].append(time.perf_counter() - t0)
            completed[0] = next(done)
            if first[c] is None:
                first[c] = rows

    threads = [threading.Thread(target=client, args=(c,), daemon=True) for c in range(n_clients)]
    for t in threads:
        t.start()
    before = service.stats_snapshot()
    t0 = time.perf_counter()
    deadline[0] = t0 + seconds
    start.wait()
    for t in threads:
        t.join(seconds + timeout)
    wall = time.perf_counter() - t0
    after = service.stats_snapshot()
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"{len(errors)} client errors: {errors[:3]}")
    lat = np.concatenate([np.asarray(x) for x in latencies]) * 1e3
    windows = after["windows"] - before["windows"]
    batches = after["device_batches"] - before["device_batches"]

    def per_batch(key):
        return (after[key] - before[key]) / batches if batches else 0.0

    return {
        "clients": n_clients,
        "requests": int(lat.size),
        "seconds": wall,
        "p50_ms": percentile(lat, 50),
        "p95_ms": percentile(lat, 95),
        "p99_ms": percentile(lat, 99),
        "clips_per_s": windows / wall,
        "device_batches": batches,
        "mean_coalesced_batch": windows / batches if batches else 0.0,
        "coalesce_ms_per_batch": per_batch("coalesce_ms_total"),
        "dispatch_ms_per_batch": per_batch("dispatch_ms_total"),
        "collect_ms_per_batch": per_batch("collect_ms_total"),
        "first": first,
    }
