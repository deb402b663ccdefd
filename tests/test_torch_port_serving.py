"""The PyTorch port's serving stack: the micro-batching EmbeddingService,
StreamingEmbedder and the HTTP server, ported case for case from
``tests/test_service.py``, and the HTTP replies held against the JAX
package's server on the same ``.ckpt``.

Left out of the port of that file: the int8 cases (in
``test_torch_port_int8.py``) and the JAX-only ones —
``test_loopback_staged_device_mode`` and
``test_bench_serving_ceiling_and_artifact`` (``tools/bench_serving.py``'s
device-staged jax.Array modes), ``test_export_embedding_model_roundtrip``
(in ``test_torch_port_files.py``) and ``test_extractor_sharded_over_mesh``
(a jax.sharding mesh; the port's ``devices`` split is tested there and
below). ``test_loopback_bench_coalesces`` becomes
``test_closed_loop_clients_coalesce`` on the port's own load generator.

The service tests run the port alone (its seeded tiny_L3 on the CPU); only
the server comparison imports the JAX package, inside its fixture, so that
this file also collects where flax is missing and runs its ``cuda``-marked
tests there.
"""

import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from l3embedding_torch import api
from l3embedding_torch.data.audio_io import pcm2float
from l3embedding_torch.embed.extract import EmbeddingExtractor, frame_uniform
from l3embedding_torch.embed.http_serve import make_server, serve_forever_in_thread
from l3embedding_torch.embed.service import EmbeddingService
from l3embedding_torch.embed.stream import StreamingEmbedder
from l3embedding_torch.tools.serve_load import closed_loop, percentile
from torch_port_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 48000


@pytest.fixture(scope="module")
def extractor():
    return EmbeddingExtractor(None, "tiny_L3", "original", device="cpu")


@pytest.fixture(scope="module")
def service(extractor):
    with EmbeddingService(extractor, max_batch_size=32, max_latency_ms=20) as svc:
        yield svc


def test_single_request(service):
    w = np.random.RandomState(0).randn(3, SR).astype(np.float32) * 0.1
    emb = service.embed(w)
    assert emb.shape == (3, 350)
    np.testing.assert_allclose(emb, service.extractor.embed_windows(w), rtol=1e-5, atol=1e-6)


def test_concurrent_requests_batch_and_scatter(service):
    rng = np.random.RandomState(1)
    inputs = [rng.randn(n, SR).astype(np.float32) * 0.1 for n in (1, 2, 5, 3, 1, 4)]
    results = [None] * len(inputs)

    def worker(i):
        results[i] = service.embed(inputs[i])

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(inputs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
        assert not t.is_alive()
    for w, r in zip(inputs, results):
        assert r.shape == (w.shape[0], 350)
        np.testing.assert_allclose(r, service.extractor.embed_windows(w), rtol=1e-5, atol=1e-6)


def test_closed_loop_clients_coalesce(service):
    """tools/serve_load.closed_loop (the load chip_smoke.py measures): with
    8 closed-loop one-window clients against a 20 ms coalescing window the
    service batches (mean batch > 1), every request round-trips, each
    client's rows equal the direct path's, the run goes on until it has
    its minimum of requests, the tail percentiles without 10 samples
    beyond them are left out, and the per-batch host times are read from
    the service's counters."""
    payloads = (np.random.RandomState(2).randn(4, SR) * 0.1).astype(np.float32)
    res = closed_loop(service, n_clients=8, payloads=payloads, seconds=0.0, min_requests=48)
    assert res["clients"] == 8 and 48 <= res["requests"] < 48 + 8
    assert res["clips_per_s"] > 0
    assert res["p50_ms"] > 0 and res["p95_ms"] is None and res["p99_ms"] is None
    assert res["device_batches"] < res["requests"]
    assert 1 < res["mean_coalesced_batch"] <= 32
    assert res["coalesce_ms_per_batch"] > 0 and res["dispatch_ms_per_batch"] > 0
    assert res["collect_ms_per_batch"] >= 0
    want = service.extractor.embed_windows(payloads)
    for c, rows in enumerate(res["first"]):
        np.testing.assert_allclose(rows, want[c % 4][None], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n,p,reported", [(19, 50, False), (20, 50, True), (199, 95, False),
                                          (200, 95, True), (999, 99, False), (1000, 99, True)])
def test_percentile_needs_ten_samples_beyond(n, p, reported):
    """A latency percentile is reported only where at least 10 samples lie
    beyond it."""
    lat = np.arange(n, dtype=np.float64)
    got = percentile(lat, p)
    assert (got is not None) == reported
    if reported:
        assert got == np.percentile(lat, p)


def test_embed_windows_async_matches_sync(service):
    """embed_windows_async returns an EmbeddingRows handle over the same
    computation: its result() equals embed_windows bit for bit, including
    sizes that are not a bucket."""
    ex = service.extractor
    rng = np.random.RandomState(3)
    for n in (1, 3, 16, 17):
        w = rng.randn(n, SR).astype(np.float32) * 0.1
        handle = ex.embed_windows_async(w)
        assert handle.shape == (n, 350)
        np.testing.assert_array_equal(handle.result(), ex.embed_windows(w))


def test_pipeline_depth_overlap_and_sync_mode(service):
    """pipeline_depth > 1 keeps dispatch ahead of collection without
    reordering or corrupting scatter; depth=1 (synchronous) gives the same
    results."""
    ex = service.extractor
    rng = np.random.RandomState(4)
    inputs = [rng.randn(n, SR).astype(np.float32) * 0.1 for n in (2, 1, 3, 1, 2, 4, 1, 1)]
    want = [ex.embed_windows(w) for w in inputs]
    for depth in (1, 3):
        with EmbeddingService(ex, max_batch_size=4, max_latency_ms=5, pipeline_depth=depth) as svc:
            futs = [svc.submit(w) for w in inputs]
            for f, w, expect in zip(futs, inputs, want):
                got = f.result(timeout=120)
                assert got.shape == (w.shape[0], 350)
                np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-6)


def test_stats_snapshot_and_drain(service):
    """The counters behind /statz, and the graceful half of a SIGTERM
    shutdown."""
    rng = np.random.RandomState(6)
    with EmbeddingService(service.extractor, max_batch_size=8, max_latency_ms=5, pipeline_depth=2) as svc:
        futs = [svc.submit(rng.randn(n, SR).astype(np.float32) * 0.1) for n in (1, 2, 3)]
        assert svc.drain(timeout=60)
        for f in futs:
            f.result(timeout=1)  # drained == already resolved
        st = svc.stats_snapshot()
    assert st["requests"] == 3
    assert st["windows"] == 6
    assert 1 <= st["device_batches"] <= 3
    assert st["errors"] == 0
    assert st["latency_ms_p50"] > 0
    assert st["latency_ms_p95"] >= st["latency_ms_p50"]
    assert st["mean_coalesced_batch"] >= 1
    assert st["queue_depth"] == 0 and st["inflight_batches"] == 0
    assert st["coalesce_ms_total"] > 0 and st["dispatch_ms_total"] > 0 and st["collect_ms_total"] >= 0
    assert not st["closed"]


def test_service_on_a_split_extractor(extractor):
    """The service over an extractor split on two CPU "devices" (the
    port's mesh): the same rows as one device."""
    split = EmbeddingExtractor(None, "tiny_L3", "original", devices=["cpu", "cpu"])
    w = (np.random.RandomState(5).randn(5, SR) * 0.1).astype(np.float32)
    with EmbeddingService(split, max_batch_size=8, max_latency_ms=5) as svc:
        np.testing.assert_array_equal(svc.embed(w), extractor.embed_windows(w))


def test_streaming_matches_file_path(service):
    """StreamingEmbedder fed chunks of random sizes reproduces the file
    path row for row."""
    ex = service.extractor
    rng = np.random.RandomState(7)
    audio = (rng.randn(int(3.7 * SR)) * 0.1).astype(np.float32)
    stream = StreamingEmbedder(ex)
    rows, i = [], 0
    while i < len(audio):
        n = int(rng.randint(1000, 60000))
        out = stream.feed(audio[i:i + n])
        assert out.ndim == 2
        rows.append(out)
        i += n
    rows.append(stream.flush())
    got = np.concatenate([r for r in rows if r.size], axis=0)
    want = ex.embed_audio(audio)
    assert got.shape == want.shape == (len(frame_uniform(audio, ex.sr)), 350)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert len(stream._buf) <= stream.frame_length  # memory bounded at ~1 window
    assert stream.windows_emitted == len(want)


def test_streaming_short_and_empty_streams(service):
    """Streams shorter than one window emit their single centered window at
    flush(), the empty stream included."""
    ex = service.extractor
    short = (np.random.RandomState(8).randn(SR // 2) * 0.1).astype(np.float32)
    stream = StreamingEmbedder(ex)
    assert stream.feed(short).shape == (0, 0)  # dim unknown before the first emit
    np.testing.assert_allclose(stream.flush(), ex.embed_audio(short), rtol=1e-5, atol=1e-6)
    assert stream.flush().shape == (0, 350)  # idempotent once sealed
    empty = StreamingEmbedder(ex)
    np.testing.assert_allclose(empty.flush(), ex.embed_audio(np.zeros(0, np.float32)), rtol=1e-5, atol=1e-6)


def test_streaming_hop_larger_than_window(service):
    """hop > window length reproduces the file path's window starts."""
    ex = service.extractor
    rng = np.random.RandomState(9)
    audio = (rng.randn(int(5.3 * SR)) * 0.1).astype(np.float32)
    stream = StreamingEmbedder(ex, hop_size=2.0)
    rows, i = [], 0
    while i < len(audio):
        n = int(rng.randint(1000, 90000))
        rows.append(stream.feed(audio[i:i + n]))
        i += n
    rows.append(stream.flush())
    got = np.concatenate([r for r in rows if r.size], axis=0)
    want = ex.embed_audio(audio, hop_size=2.0)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert len(stream._buf) <= stream.frame_length


def test_streaming_int_pcm_and_errors(service):
    """Integer PCM converts like pcm2float; sealed or malformed streams fail
    loudly."""
    ex = service.extractor
    pcm = (np.random.RandomState(9).randn(ex.sr + 100) * 8000).astype(np.int16)
    s_int = StreamingEmbedder(ex)
    got = s_int.feed(pcm)
    np.testing.assert_allclose(got, StreamingEmbedder(ex).feed(pcm2float(pcm)), rtol=1e-6, atol=1e-7)
    s_int.flush()
    with pytest.raises(RuntimeError):
        s_int.feed(pcm)
    with pytest.raises(ValueError):
        StreamingEmbedder(ex).feed(np.zeros((2, 100), np.float32))
    with pytest.raises(ValueError):
        StreamingEmbedder(ex, hop_size=0.0)


def test_extractor_fast_path_cosine():
    """fast=True within the bf16 gate of the f32 tower on the same weights
    (tiny_L3 stays f32 in both packages, so its rows are equal)."""
    windows = (np.random.RandomState(5).randn(4, SR) * 0.1).astype(np.float32)
    slow = EmbeddingExtractor(None, "tiny_L3", "short", device="cpu")
    fast = EmbeddingExtractor(None, "tiny_L3", "short", fast=True, device="cpu")
    a, b = slow.embed_windows(windows), fast.embed_windows(windows)
    assert a.shape == b.shape
    for x, y in zip(a, b):
        assert (x @ y) / (np.linalg.norm(x) * np.linalg.norm(y) + 1e-12) > 0.999


def test_closed_service_fails_requests_instead_of_hanging(extractor):
    """submit() after close, and items still queued at close, resolve with
    an error instead of hanging their callers."""
    svc = EmbeddingService(extractor, max_batch_size=4, max_latency_ms=5)
    svc.close()
    fut = svc.submit(np.zeros((1, SR), np.float32))
    with pytest.raises(RuntimeError, match="closed"):
        fut.result(timeout=5)
    orphan = Future()
    svc._q.put((np.zeros((1, SR), np.float32), orphan))
    svc.close()
    with pytest.raises(RuntimeError, match="closed before serving"):
        orphan.result(timeout=5)


def test_submit_close_race_every_future_resolves(extractor):
    """Under the submit lock every future that submit() returned resolves
    (result or error), with close() racing four submitting threads."""
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for _ in range(5):
            svc = EmbeddingService(extractor, max_batch_size=8, max_latency_ms=1)
            futures, flock = [], threading.Lock()
            start = threading.Barrier(5)

            def spam():
                start.wait()
                for _ in range(20):
                    f = svc.submit(np.zeros((1, SR), np.float32))
                    with flock:
                        futures.append(f)

            threads = [threading.Thread(target=spam) for _ in range(4)]
            for t in threads:
                t.start()
            start.wait()
            svc.close()
            for t in threads:
                t.join(60)
                assert not t.is_alive()
            assert len(futures) == 80
            for f in futures:
                try:
                    f.result(timeout=10)
                except RuntimeError:
                    pass
    finally:
        sys.setswitchinterval(switch)


def test_http_serve_cli_sigterm_graceful_shutdown():
    """python -m l3embedding_torch.embed.http_serve --device cpu serves, then
    drains and exits 0 on SIGTERM."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    proc = subprocess.Popen(
        [sys.executable, "-m", "l3embedding_torch.embed.http_serve", "--device", "cpu",
         "--model-type", "tiny_L3", "--pooling", "short", "--port", str(port), "--max-latency-ms", "5"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        deadline, up = time.time() + 120, False
        while time.time() < deadline and not up:
            if proc.poll() is not None:
                raise AssertionError(f"server died early:\n{proc.stdout.read()[-2000:]}")
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=5) as r:
                    up = r.status == 200
            except OSError:
                time.sleep(0.5)
        assert up, "server never came up"
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/embed_windows", data=np.zeros((1, SR), np.float32).tobytes(),
            headers={"Content-Type": "application/octet-stream", "X-Num-Windows": "1"})
        with urllib.request.urlopen(req, timeout=120) as r:
            r.read()
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out[-2000:]
        assert "shutdown complete (1 requests served)" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.mark.parametrize("flags, error", [
    pytest.param(["--int8"], SystemExit, id="flags0"),  # no --int8-calib: argparse refuses
    pytest.param(["--int8-artifact", "artifact.npz"], FileNotFoundError, id="flags1"),
])
def test_http_serve_int8_flags_raise(flags, error):
    """The int8 flags serve the int8 tower (tests/test_torch_port_int8.py
    serves an artifact through them); int8 flags it cannot honour raise
    before a server starts: no silent f32 serving."""
    from l3embedding_torch.embed import http_serve

    with pytest.raises(error):
        http_serve.main(flags + ["--device", "cpu"])


def test_service_extractor_failure_fails_futures_not_threads():
    """A raising extractor fails that batch's futures, at dispatch and at
    collection (a handle whose result() raises), while later requests are
    served and /statz counts the errors."""

    class FlakyExtractor:
        sr = SR

        def __init__(self):
            self.fail_dispatch = False
            self.fail_collect = False

        def embed_windows_async(self, windows):
            if self.fail_dispatch:
                raise RuntimeError("boom at dispatch")
            n, fail = windows.shape[0], self.fail_collect

            class Handle:
                shape = (n, 4)

                def result(self):
                    if fail:
                        raise RuntimeError("boom at collect")
                    return np.ones((n, 4), np.float32)

            return Handle()

    ex = FlakyExtractor()
    with EmbeddingService(ex, max_batch_size=4, max_latency_ms=2, pipeline_depth=2) as svc:
        w = np.zeros((1, SR), np.float32)
        assert svc.embed(w).shape == (1, 4)
        ex.fail_dispatch = True
        with pytest.raises(RuntimeError, match="boom at dispatch"):
            svc.submit(w).result(timeout=30)
        ex.fail_dispatch = False
        ex.fail_collect = True
        with pytest.raises(RuntimeError, match="boom at collect"):
            svc.submit(w).result(timeout=30)
        ex.fail_collect = False
        assert svc.embed(w).shape == (1, 4)
        assert svc.drain(timeout=30)
        st = svc.stats_snapshot()
    assert st["errors"] == 2
    assert st["requests"] == 4


def test_mixed_width_submits_fail_batch_not_thread(service):
    """Mismatched window widths coalesced into one batch fail those futures
    and leave the dispatcher serving."""
    futs = [service.submit(np.zeros((1, SR), np.float32)),
            service.submit(np.zeros((1, SR // 2), np.float32))]
    outcomes = []
    for f in futs:
        try:
            outcomes.append(("ok", f.result(timeout=30).shape))
        except ValueError as e:
            outcomes.append(("err", str(e)[:40]))
    assert any(kind == "err" for kind, _ in outcomes), outcomes
    assert service.embed(np.zeros((2, SR), np.float32)).shape[0] == 2


def test_cancelled_future_does_not_poison_batch(service):
    """A future cancelled in flight does not fail the other requests of its
    batch."""
    n_ok = 0
    for _ in range(5):
        futs = [service.submit(np.zeros((1, SR), np.float32)) for _ in range(6)]
        futs[0].cancel()
        for f in futs[1:]:
            assert f.result(timeout=30).shape[0] == 1
            n_ok += 1
    assert n_ok == 25


def _url(srv, path):
    host, port = srv.server_address[:2]
    return f"http://{host}:{port}{path}"


def _post(srv, path, data=b"", headers=None):
    return urllib.request.urlopen(urllib.request.Request(_url(srv, path), data=data, headers=headers or {}))


class TestHTTPServing:
    """The stdlib HTTP front over the micro-batching service."""

    @pytest.fixture(scope="class")
    def server(self):
        ex = EmbeddingExtractor(None, "tiny_L3", "original", device="cpu")
        srv = make_server(ex, host="127.0.0.1", port=0, max_latency_ms=20)
        serve_forever_in_thread(srv)
        yield srv, ex
        srv.shutdown()
        srv.l3_service.close()
        srv.server_close()

    def test_healthz(self, server):
        srv, _ = server
        with urllib.request.urlopen(_url(srv, "/healthz")) as r:
            body = json.load(r)
        assert body == {"status": "ok", "model_type": "tiny_L3", "pooling": "original", "dim": 350, "sr": SR}

    def test_embed_json_matches_direct(self, server):
        srv, ex = server
        audio = (np.random.RandomState(7).randn(SR * 2) * 0.1).astype(np.float32)
        with _post(srv, "/v1/embed", json.dumps({"audio": audio.tolist(), "hop": 0.5}).encode(),
                   {"Content-Type": "application/json"}) as r:
            body = json.load(r)
        got = np.asarray(body["embeddings"], np.float32)
        direct = ex.embed_windows(frame_uniform(audio, hop_size=0.5))
        assert body["dim"] == direct.shape[1] and body["num_windows"] == direct.shape[0]
        np.testing.assert_allclose(got, direct, rtol=1e-4, atol=1e-5)

    def test_embed_windows_raw_roundtrip(self, server):
        srv, ex = server
        w = (np.random.RandomState(8).randn(3, SR) * 0.1).astype(np.float32)
        with _post(srv, "/v1/embed_windows", w.astype("<f4").tobytes(),
                   {"Content-Type": "application/octet-stream", "X-Num-Windows": "3"}) as r:
            dim = int(r.headers["X-Embedding-Dim"])
            got = np.frombuffer(r.read(), "<f4").reshape(3, dim)
        np.testing.assert_allclose(got, ex.embed_windows(w), rtol=1e-5, atol=1e-6)

    def test_stream_session_matches_file_path(self, server):
        """Feeding a stream chunk by chunk over HTTP gives /v1/embed's rows;
        the session is gone after flush."""
        srv, ex = server
        rng = np.random.RandomState(11)
        audio = (rng.randn(int(2.3 * SR)) * 0.1).astype(np.float32)
        with _post(srv, "/v1/stream/open", json.dumps({"hop": 0.5}).encode()) as r:
            opened = json.load(r)
        sid = opened["stream_id"]
        assert opened["dim"] == 350 and opened["sr"] == SR
        rows, i = [], 0
        while i < len(audio):
            n = int(rng.randint(5000, 50000))
            with _post(srv, f"/v1/stream/{sid}/feed", audio[i:i + n].astype("<f4").tobytes()) as r:
                k = int(r.headers["X-Num-Windows"])
                rows.append(np.frombuffer(r.read(), "<f4").reshape(k, 350))
            i += n
        with _post(srv, f"/v1/stream/{sid}/flush") as r:
            rows.append(np.frombuffer(r.read(), "<f4").reshape(int(r.headers["X-Num-Windows"]), 350))
        got = np.concatenate(rows, axis=0)
        want = ex.embed_windows(frame_uniform(audio, hop_size=0.5))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(srv, f"/v1/stream/{sid}/feed", b"\x00" * 8)
        assert ei.value.code == 404

    def test_stream_unknown_id_and_bad_body(self, server):
        srv, _ = server
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(srv, "/v1/stream/nope/feed", b"\x00" * 8)
        assert ei.value.code == 404
        with _post(srv, "/v1/stream/open") as r:  # empty body: ok
            sid = json.load(r)["stream_id"]
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(srv, f"/v1/stream/{sid}/feed", b"\x00" * 7)
        assert ei.value.code == 400  # not a multiple of 4
        with _post(srv, f"/v1/stream/{sid}/flush") as r:
            assert int(r.headers["X-Num-Windows"]) == 1  # the empty stream's one window

    def test_stream_robustness_empty_feed_flush_body_and_bad_hop(self, server):
        """On one keep-alive connection: an empty feed is a no-op, a flush
        with a body is drained, a non-finite hop is a 400, and an oversized
        open body is refused by the size cap."""
        srv, _ = server
        host, port = srv.server_address[:2]
        conn = http.client.HTTPConnection(host, port, timeout=30)
        try:
            conn.request("POST", "/v1/stream/open", b"", {"Content-Length": "0"})
            r = conn.getresponse()
            assert r.status == 200
            sid = json.loads(r.read())["stream_id"]
            conn.request("POST", f"/v1/stream/{sid}/feed", b"", {"Content-Length": "0"})
            r = conn.getresponse()
            assert r.status == 200 and int(r.headers["X-Num-Windows"]) == 0
            assert r.read() == b""
            conn.request("POST", f"/v1/stream/{sid}/flush", np.zeros(1000, "<f4").tobytes())
            r = conn.getresponse()
            assert r.status == 200
            r.read()
            conn.request("GET", "/healthz")
            r = conn.getresponse()
            assert r.status == 200 and json.loads(r.read())["status"] == "ok"
        finally:
            conn.close()
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(srv, "/v1/stream/open", b'{"hop": 1e999}')
        assert ei.value.code == 400
        conn = http.client.HTTPConnection(host, port, timeout=30)
        try:
            conn.putrequest("POST", "/v1/stream/open")
            conn.putheader("Content-Length", str((1 << 30) + 1))
            conn.endheaders()
            assert conn.getresponse().status == 400
        finally:
            conn.close()

    def test_concurrent_streams_coalesce(self, server):
        """Two interleaved sessions stay independent."""
        srv, ex = server
        rng = np.random.RandomState(12)
        clips = [(rng.randn(SR + 4800 * 3) * 0.1).astype(np.float32) for _ in range(2)]
        sids = []
        for _ in clips:
            with _post(srv, "/v1/stream/open") as r:
                sids.append(json.load(r)["stream_id"])
        rows = [[], []]
        for start in range(0, len(clips[0]), 9600):
            for j, sid in enumerate(sids):
                with _post(srv, f"/v1/stream/{sid}/feed", clips[j][start:start + 9600].astype("<f4").tobytes()) as r:
                    k = int(r.headers["X-Num-Windows"])
                    if k:
                        rows[j].append(np.frombuffer(r.read(), "<f4").reshape(k, -1))
        for j, sid in enumerate(sids):
            with _post(srv, f"/v1/stream/{sid}/flush"):
                pass
            got = np.concatenate(rows[j], axis=0)
            want = ex.embed_audio(clips[j])
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)

    def test_concurrent_http_clients(self, server):
        srv, ex = server
        rng = np.random.RandomState(9)
        audios = [(rng.randn(SR) * 0.1).astype(np.float32) for _ in range(6)]
        results = [None] * len(audios)

        def worker(i):
            with _post(srv, "/v1/embed", json.dumps({"audio": audios[i].tolist()}).encode(),
                       {"Content-Type": "application/json"}) as r:
                results[i] = np.asarray(json.load(r)["embeddings"], np.float32)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(audios))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
            assert not t.is_alive()
        for audio, got in zip(audios, results):
            np.testing.assert_allclose(got, ex.embed_windows(frame_uniform(audio)), rtol=1e-4, atol=1e-5)

    def test_concurrent_burst_no_connection_resets(self, server):
        """A 32-client simultaneous connect burst sheds no connection (the
        listen backlog is 128)."""
        srv, _ = server
        n, errors = 32, []
        payload = np.zeros((1, SR), np.float32).tobytes()
        start = threading.Barrier(n)

        def worker():
            start.wait()
            req = urllib.request.Request(_url(srv, "/v1/embed_windows"), data=payload,
                                         headers={"Content-Type": "application/octet-stream", "X-Num-Windows": "1"})
            try:
                with urllib.request.urlopen(req, timeout=120) as r:
                    r.read()
            except OSError as e:
                errors.append(repr(e))

        threads = [threading.Thread(target=worker) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(180)
            assert not t.is_alive()
        assert not errors, errors[:5]

    def test_get_with_body_drains_on_keepalive(self, server):
        srv, _ = server
        conn = http.client.HTTPConnection(*srv.server_address[:2], timeout=120)
        try:
            conn.request("GET", "/healthz", body=b'{"stray": 1}')
            resp = conn.getresponse()
            assert resp.status == 200
            resp.read()
            conn.request("GET", "/statz")
            resp = conn.getresponse()
            assert resp.status == 200
            resp.read()
        finally:
            conn.close()

    def test_http11_keepalive_connection_reuse(self, server):
        srv, _ = server
        conn = http.client.HTTPConnection(*srv.server_address[:2], timeout=120)
        payload = np.zeros((1, SR), np.float32).tobytes()
        try:
            for _ in range(3):
                conn.request("POST", "/v1/embed_windows", body=payload,
                             headers={"Content-Type": "application/octet-stream", "X-Num-Windows": "1"})
                resp = conn.getresponse()
                assert resp.status == 200 and resp.version == 11
                assert len(resp.read()) == int(resp.headers["Content-Length"])
        finally:
            conn.close()

    def test_error_reply_closes_keepalive_connection(self, server):
        """An error reply before the body was read announces and performs a
        connection close; a new connection works."""
        srv, _ = server
        payload = np.zeros((1, SR), np.float32).tobytes()
        conn = http.client.HTTPConnection(*srv.server_address[:2], timeout=120)
        try:
            conn.request("POST", "/v1/embed_windows", body=payload,
                         headers={"Content-Type": "application/octet-stream", "X-Num-Windows": "0"})
            resp = conn.getresponse()
            assert resp.status == 400
            assert resp.headers.get("Connection", "").lower() == "close"
            resp.read()
            with pytest.raises((http.client.HTTPException, ConnectionError, OSError)):
                conn.send(b"GET /healthz HTTP/1.1\r\n")
                conn.sock.settimeout(5)
                if conn.sock.recv(1) == b"":
                    raise ConnectionError("server closed the connection")
        finally:
            conn.close()
        conn = http.client.HTTPConnection(*srv.server_address[:2], timeout=120)
        try:
            conn.request("POST", "/v1/embed_windows", body=payload,
                         headers={"Content-Type": "application/octet-stream", "X-Num-Windows": "1"})
            assert conn.getresponse().status == 200
        finally:
            conn.close()

    def test_statz_endpoint(self, server):
        srv, _ = server
        with _post(srv, "/v1/embed_windows", np.zeros((2, SR), np.float32).tobytes(),
                   {"Content-Type": "application/octet-stream", "X-Num-Windows": "2"}) as r:
            r.read()
        with urllib.request.urlopen(_url(srv, "/statz")) as r:
            st = json.load(r)
        assert st["requests"] >= 1 and st["windows"] >= 2 and st["device_batches"] >= 1
        assert st["latency_ms_p50"] > 0
        assert st["pipeline_depth"] >= 1
        assert st["closed"] is False

    def test_error_paths(self, server):
        srv, _ = server
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(srv, "/v1/embed", b"{not json", {"Content-Type": "application/json"})
        assert ei.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(srv, "/v1/embed_windows", b"\x00" * 16, {"X-Num-Windows": "2"})
        assert ei.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(_url(srv, "/nope"))
        assert ei.value.code == 404


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """The port's and the JAX package's servers on one tiny_L3 .ckpt (flax
    variables, BN statistics away from identity, written by JAX)."""
    import jax

    from l3embedding_tpu.embed.extract import EmbeddingExtractor as JaxExtractor
    from l3embedding_tpu.embed.http_serve import make_server as jax_make_server
    from l3embedding_tpu.models import build_model as jax_build_model
    from l3embedding_tpu.training.checkpoints import save_variables

    v = jax.device_get(jax_build_model("tiny_L3").module().init(
        jax.random.PRNGKey(3), np.zeros((1, 224, 224, 3), np.float32),
        np.zeros((1, 1, SR), np.float32), train=False))
    v["batch_stats"] = jax.tree_util.tree_map(lambda x: x + 0.05, v["batch_stats"])
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny.ckpt")
    save_variables(path, v["params"], v["batch_stats"])
    pair = {"torch": make_server(EmbeddingExtractor(path, "tiny_L3", "short", device="cpu"), port=0,
                                 max_latency_ms=5),
            "jax": jax_make_server(JaxExtractor(path, "tiny_L3", "short"), port=0, max_latency_ms=5)}
    for srv in pair.values():
        serve_forever_in_thread(srv)
    yield pair
    for srv in pair.values():
        srv.shutdown()
        srv.l3_service.close()
        srv.server_close()


def _cos_rows(a, b):
    assert a.shape == b.shape and a.shape[0] > 0
    return min((u @ v) / (np.linalg.norm(u) * np.linalg.norm(v) + 1e-30)
               for u, v in zip(a.astype(np.float64), b.astype(np.float64)))


def test_http_embed_replies_match_jax_server(servers):
    """/healthz equal; /v1/embed on a 2.37 s clip at 44.1 kHz (resampled,
    hop 0.25): the same row count and dim, rows at cosine >= 0.99999."""
    with urllib.request.urlopen(_url(servers["torch"], "/healthz")) as r:
        ours = json.load(r)
    with urllib.request.urlopen(_url(servers["jax"], "/healthz")) as r:
        assert ours == json.load(r)
    audio = (np.random.RandomState(21).randn(int(2.37 * 44100)) * 0.1).astype(np.float32)
    body = json.dumps({"audio": audio.tolist(), "sr": 44100, "hop": 0.25}).encode()
    replies = {}
    for name, srv in servers.items():
        with _post(srv, "/v1/embed", body, {"Content-Type": "application/json"}) as r:
            replies[name] = json.load(r)
    assert replies["torch"]["num_windows"] == replies["jax"]["num_windows"] == 6
    assert replies["torch"]["dim"] == replies["jax"]["dim"] == 350
    assert _cos_rows(np.asarray(replies["torch"]["embeddings"]), np.asarray(replies["jax"]["embeddings"])) >= 0.99999


def test_http_raw_and_stream_replies_match_jax_server(servers):
    """/v1/embed_windows and a stream session (open, feed in 0.37 s chunks,
    flush): the same headers and row counts as JAX's server, rows at cosine
    >= 0.99999."""
    rng = np.random.RandomState(22)
    windows = (rng.randn(3, SR) * 0.1).astype(np.float32)
    clip = (rng.randn(int(1.9 * SR)) * 0.1).astype(np.float32)
    got = {}
    for name, srv in servers.items():
        with _post(srv, "/v1/embed_windows", windows.tobytes(), {"X-Num-Windows": "3"}) as r:
            raw = (r.headers["X-Num-Windows"], r.headers["X-Embedding-Dim"],
                   np.frombuffer(r.read(), "<f4").reshape(3, -1))
        with _post(srv, "/v1/stream/open", json.dumps({"hop": 0.1}).encode()) as r:
            sid = json.load(r)["stream_id"]
        counts, rows = [], []
        for i in range(0, clip.size, 17760):
            with _post(srv, f"/v1/stream/{sid}/feed", clip[i:i + 17760].tobytes()) as r:
                k = int(r.headers["X-Num-Windows"])
                counts.append(k)
                rows.append(np.frombuffer(r.read(), "<f4").reshape(k, 350))
        with _post(srv, f"/v1/stream/{sid}/flush") as r:
            counts.append(int(r.headers["X-Num-Windows"]))
            r.read()
        got[name] = (raw, counts, np.concatenate(rows))
    (raw, counts, rows), (jraw, jcounts, jrows) = got["torch"], got["jax"]
    assert raw[:2] == jraw[:2] == ("3", "350")
    assert counts == jcounts and sum(counts) == 10
    assert _cos_rows(raw[2], jraw[2]) >= 0.99999
    assert _cos_rows(rows, jrows) >= 0.99999


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [False, True], ids=["f32", "bf16"])
def test_cuda_device_framing_equals_host_framing_and_launches_the_mel_kernel(fast):
    """On the card: device framing cuts the windows there (it uploads the
    clip once), launches the mel kernel, and gives the host path's rows."""
    _need_cuda()
    from l3embedding_torch.ops import mel_kernel

    ex = EmbeddingExtractor(None, "cnn_L3_melspec2", "short", fast=fast, db_batch_global=True)
    clip = (np.random.RandomState(31).randn(int(2.37 * SR)) * 0.1).astype(np.float32)
    clip[-3000:] *= 15.0
    host = ex.embed_audio(clip, device_framing=False)
    mel_kernel.LAUNCHES.clear()
    b0 = ex.bytes_uploaded
    dev = ex.embed_audio(clip, device_framing=True)
    assert ex.bytes_uploaded - b0 == clip.size * 4
    assert mel_kernel.LAUNCHES["bf16" if fast else "f32"] == 1
    assert dev.shape == host.shape == (14, 512)
    cos = _cos_rows(dev, host)
    assert cos >= (0.999 if fast else 0.99999), cos


@pytest.mark.cuda
def test_cuda_back_to_back_async_calls_keep_their_rows():
    """Two embed_windows_async calls in a row, with different inputs, before
    either is collected: each handle gives its own rows (the pinned upload
    buffer of the first is not reused while its copy is in flight, and each
    handle owns its pinned result buffer)."""
    _need_cuda()
    ex = EmbeddingExtractor(None, "cnn_L3_melspec2", "short")
    rng = np.random.RandomState(32)
    a, b = ((rng.randn(64, SR) * s).astype(np.float32) for s in (0.3, 0.01))
    want_a, want_b = ex.embed_windows(a), ex.embed_windows(b)
    for _ in range(3):
        ha, hb = ex.embed_windows_async(a), ex.embed_windows_async(b)
        got_b, got_a = hb.result(), ha.result()
        np.testing.assert_allclose(got_a, want_a, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got_b, want_b, rtol=1e-5, atol=1e-5)
        assert not np.allclose(got_a, got_b)


@pytest.mark.cuda
def test_cuda_int8_artifact_raises():
    """On the card too a missing int8 artifact raises before anything is
    built (chip_smoke.py's phase_int8 serves a real one there)."""
    _need_cuda()
    with pytest.raises(FileNotFoundError):
        api.load_audio_embedding_model(int8_artifact="artifact.npz", device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [False, True], ids=["f32", "bf16"])
def test_cuda_devices_split_matches_one_card(fast):
    """`devices` over every visible card (two or more): the bucket split in
    equal chunks, each replica on its own card and stream, the rows copied
    back behind one event per card; the rows hold against one card's, also
    through the service."""
    _need_cuda()
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        pytest.skip("needs two or more cards")
    one = EmbeddingExtractor(None, "cnn_L3_melspec2", "short", fast=fast)
    split = EmbeddingExtractor(None, "cnn_L3_melspec2", "short", fast=fast,
                               devices=[f"cuda:{i}" for i in range(n_cards)])
    assert [m.tower.embedding_conv.weight.device.index for m in split.models] == list(range(n_cards))
    gate = 0.999 if fast else 0.99999
    rng = np.random.RandomState(33)
    for n in (5, 37):
        w = (rng.randn(n, SR) * 0.1).astype(np.float32)
        assert _cos_rows(split.embed_windows(w), one.embed_windows(w)) >= gate
    w = (rng.randn(24, SR) * 0.1).astype(np.float32)
    with EmbeddingService(split, max_batch_size=32, max_latency_ms=5) as svc:
        futs = [svc.submit(w[i:i + 3]) for i in range(0, 24, 3)]
        got = np.concatenate([f.result(timeout=120) for f in futs])
    assert _cos_rows(got, one.embed_windows(w)) >= gate
