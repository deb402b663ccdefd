"""HTTP serving front for the embedding service (stdlib-only; port of
``l3embedding_tpu/embed/http_serve.py``).

Turns the in-process micro-batching `EmbeddingService` into a deployable
endpoint: concurrent requests from any number of clients are coalesced
into device batches by the service's dispatcher, so one resident
extractor (optionally replicated over every visible card, ``--mesh``)
serves the whole host.

Endpoints
---------
GET  /healthz
    → {"status": "ok", "model_type": ..., "pooling": ..., "dim": ...}

GET  /statz
    → live serving counters: requests/windows/device_batches/errors,
    queue + in-flight depth, coalesced-batch stats, submit→resolve
    latency percentiles (p50/p95/p99 ms). SIGTERM drains in-flight
    requests (bounded) before exiting 0.

POST /v1/embed            (application/json)
    {"audio": [... float PCM in [-1,1] ...], "sr": 48000, "hop": 0.1}
    → {"embeddings": [[...], ...], "num_windows": N, "dim": D}
    Arbitrary-length audio; framed into overlapping 1 s windows exactly
    like the file extraction path (reference features.py:256-306).

POST /v1/embed_windows    (application/octet-stream)
    Raw little-endian float32, shape (N, 48000) row-major; the
    X-Num-Windows header carries N.
    → raw little-endian float32 (N, D); X-Embedding-Dim carries D.

Streaming sessions (real-time PCM; embed/stream.py semantics — the
rows are identical to /v1/embed on the concatenated stream):

POST /v1/stream/open      (optional JSON {"hop": 0.1})
    → {"stream_id": ...}
POST /v1/stream/<id>/feed (application/octet-stream, raw <f4 mono PCM,
    any length) → raw float32 (K, D) for the K windows this chunk
    completed (possibly 0); X-Num-Windows carries K.
POST /v1/stream/<id>/flush
    → final rows in the same raw format; the session is closed.
    Windows from concurrent streams coalesce into shared device batches
    through the same micro-batching service as one-shot requests.

Run: python -m l3embedding_torch.embed.http_serve MODEL.ckpt \
         --model-type cnn_L3_melspec2 --pooling short --port 8471 [--device cpu]

The JAX server's ``--compilation-cache`` has no counterpart here (PyTorch
compiles nothing at start-up; the CUDA kernels are built once into
``build/l3torch_kernels/``) and is left out. The int8 flags serve the int8
tower (``embed/quantized.py``): ``--int8-artifact FILE``, or ``--int8
--int8-calib DIR`` to calibrate at start (``--int8-save-artifact`` keeps it).
"""

from __future__ import annotations

import json
import logging
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..data.audio_io import resample
from .extract import EmbeddingExtractor, frame_uniform
from .service import EmbeddingService
from .stream import StreamingEmbedder

LOGGER = logging.getLogger("l3embedding_torch.embed.http")


class TooManyStreams(RuntimeError):
    """Stream-session capacity exhausted — mapped to 503 (retryable),
    distinct from genuine OverflowErrors in client numeric input,
    which are 400s (a load balancer treating 503 as backend-unhealthy
    must not eject a server over one malformed request)."""


class _ServiceWindows:
    """StreamingEmbedder-compatible view of the micro-batching service:
    windows from concurrent streams coalesce into shared device batches
    instead of each stream dispatching its own."""

    def __init__(self, service: EmbeddingService, sr: int):
        self.sr = sr
        self._service = service

    def embed_windows(self, windows: np.ndarray) -> np.ndarray:
        return self._service.submit(
            np.ascontiguousarray(windows, np.float32)
        ).result()


class _StreamSession:
    def __init__(self, embedder: StreamingEmbedder):
        self.embedder = embedder
        self.lock = threading.Lock()  # serialize feeds to one stream
        self.last_used = time.monotonic()


class _State:
    """Shared handler state (BaseHTTPRequestHandler is per-request)."""

    MAX_STREAMS = 256
    STREAM_IDLE_S = 600.0

    def __init__(self, extractor: EmbeddingExtractor,
                 service: EmbeddingService):
        self.extractor = extractor
        self.service = service
        # 1-second windows at the extractor's sample rate (frame_uniform
        # frames to sr*1) — NOT a hard-coded 48000, so an extractor
        # built for another rate serves correctly-sized windows.
        self.window_samples = int(extractor.sr)
        dim_probe = extractor.embed_windows(
            np.zeros((1, self.window_samples), np.float32)
        )
        self.dim = int(dim_probe.shape[1])
        self.streams: dict[str, _StreamSession] = {}
        self.streams_lock = threading.Lock()

    def open_stream(self, hop: float) -> str:
        with self.streams_lock:
            # Opportunistic GC: sessions idle past the TTL (a client
            # that died without flushing) are dropped when new ones
            # open — no background reaper thread needed.
            now = time.monotonic()
            for sid in [s for s, ses in self.streams.items()
                        if now - ses.last_used > self.STREAM_IDLE_S]:
                del self.streams[sid]
            if len(self.streams) >= self.MAX_STREAMS:
                raise TooManyStreams(
                    f"too many open streams ({self.MAX_STREAMS}); flush "
                    "stale sessions or raise _State.MAX_STREAMS"
                )
            sid = uuid.uuid4().hex
            self.streams[sid] = _StreamSession(StreamingEmbedder(
                _ServiceWindows(self.service, self.window_samples),
                hop_size=hop,
            ))
            return sid

    def get_stream(self, sid: str) -> _StreamSession:
        with self.streams_lock:
            session = self.streams.get(sid)
        if session is None:
            raise KeyError(f"unknown or closed stream {sid!r}")
        session.last_used = time.monotonic()
        return session

    def close_stream(self, sid: str) -> None:
        with self.streams_lock:
            self.streams.pop(sid, None)




class _Handler(BaseHTTPRequestHandler):
    state: _State  # set by make_server

    # HTTP/1.1 keep-alive: closed-loop clients reuse one TCP connection
    # instead of reconnecting per clip (the stdlib default is HTTP/1.0,
    # one connection per request). Safe because every reply path sets
    # Content-Length (_reply_json and the raw /v1/embed_windows path).
    protocol_version = "HTTP/1.1"

    # -- plumbing -----------------------------------------------------
    def log_message(self, fmt, *args):  # route to our logger, not stderr
        LOGGER.debug("%s - %s", self.address_string(), fmt % args)

    def _reply_json(self, code: int, obj) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if self.close_connection:
            # Announce the close so HTTP/1.1 clients don't try to reuse
            # the connection we're about to drop.
            self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(body)

    def _reply_error(self, code: int, message: str) -> None:
        # Error paths can fire before the request body was consumed
        # (missing/zero Content-Length, oversized body, bad headers).
        # Under HTTP/1.1 keep-alive the unread bytes would be parsed as
        # the NEXT request line on this connection, desyncing the
        # client; closing the connection after an error reply is always
        # protocol-correct.
        self.close_connection = True
        self._reply_json(code, {"error": message})

    def _read_body(self, required: bool = True) -> bytes:
        """Read (and thereby drain) the request body, size-capped.

        Every endpoint must consume its body through this helper even
        when the content is ignored — unread bytes on an HTTP/1.1
        keep-alive connection get parsed as the NEXT request line."""
        length = int(self.headers.get("Content-Length", 0))
        if length <= 0:
            if required:
                raise ValueError("empty request body")
            return b""
        if length > 1 << 30:
            raise ValueError("request body too large")
        return self.rfile.read(length)

    # -- endpoints ----------------------------------------------------
    def do_GET(self):
        st = self.state
        # Honor _read_body's invariant on GETs too: a client that sends
        # a body with its GET on a keep-alive connection would otherwise
        # leave unread bytes to be parsed as the next request line.
        try:
            self._read_body(required=False)
        except ValueError as e:
            return self._reply_error(400, str(e))
        if self.path == "/statz":
            # Serving observability: request/window/batch counters,
            # coalesced-batch stats, submit→resolve latency percentiles
            # (the reference's observability surface is training-side
            # only — history CSV/gsheets; serving gets its own here).
            return self._reply_json(200, st.service.stats_snapshot())
        if self.path != "/healthz":
            return self._reply_error(404, f"unknown path {self.path!r}")
        self._reply_json(200, {
            "status": "ok",
            "model_type": st.extractor.model_type,
            "pooling": st.extractor.pooling_type,
            "dim": st.dim,
            "sr": st.extractor.sr,
        })

    def do_POST(self):
        try:
            if self.path == "/v1/embed":
                return self._embed_json()
            if self.path == "/v1/embed_windows":
                return self._embed_windows_raw()
            if self.path == "/v1/stream/open":
                return self._stream_open()
            parts = self.path.strip("/").split("/")
            if len(parts) == 4 and parts[:2] == ["v1", "stream"]:
                if parts[3] == "feed":
                    return self._stream_feed(parts[2])
                if parts[3] == "flush":
                    return self._stream_flush(parts[2])
            return self._reply_error(404, f"unknown path {self.path!r}")
        except KeyError as e:
            # Unknown/closed stream ids are 404 (the resource), not 400.
            return self._reply_error(404, str(e))
        except TooManyStreams as e:
            return self._reply_error(503, str(e))
        except (ValueError, OverflowError, json.JSONDecodeError) as e:
            # OverflowError here is client numeric input (e.g. a JSON
            # 1e999 hop parses to inf; int(inf*sr) overflows) — 400.
            return self._reply_error(400, str(e))
        except Exception as e:  # noqa: BLE001 — surface, don't kill thread
            LOGGER.exception("request failed")
            return self._reply_error(500, repr(e))

    def _embed_json(self):
        st = self.state
        payload = json.loads(self._read_body())
        if "audio" not in payload:
            raise ValueError("missing 'audio' field")
        audio = np.asarray(payload["audio"], np.float32)
        if audio.ndim != 1:
            raise ValueError(f"audio must be 1-D, got shape {audio.shape}")
        sr = int(payload.get("sr", st.extractor.sr))
        hop = float(payload.get("hop", 0.1))
        if sr <= 0:
            raise ValueError(f"sr must be positive, got {sr}")
        if not int(hop * st.extractor.sr) >= 1:  # also rejects NaN
            raise ValueError(f"hop {hop}s is below one sample at "
                             f"{st.extractor.sr} Hz")
        # Same polyphase resampler as the extraction path (data/audio_io.py).
        audio = resample(audio, sr, st.extractor.sr).astype(np.float32)
        windows = frame_uniform(audio, sr=st.extractor.sr, hop_size=hop)
        emb = st.service.submit(
            np.ascontiguousarray(windows, np.float32)
        ).result()
        self._reply_json(200, {
            "embeddings": np.asarray(emb, np.float32).tolist(),
            "num_windows": int(emb.shape[0]),
            "dim": int(emb.shape[1]),
        })

    def _reply_rows(self, emb: np.ndarray) -> None:
        blob = np.asarray(emb, np.float32).astype("<f4").tobytes()
        self.send_response(200)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(len(blob)))
        self.send_header("X-Num-Windows", str(emb.shape[0]))
        self.send_header("X-Embedding-Dim", str(self.state.dim))
        self.end_headers()
        self.wfile.write(blob)

    def _stream_open(self):
        hop = 0.1
        body = self._read_body(required=False)  # optional, size-capped
        if body:
            payload = json.loads(body)
            hop = float(payload.get("hop", 0.1))
        sid = self.state.open_stream(hop)
        self._reply_json(200, {
            "stream_id": sid,
            "sr": self.state.extractor.sr,
            "dim": self.state.dim,
        })

    def _stream_feed(self, sid: str):
        session = self.state.get_stream(sid)
        # Empty chunks are a well-defined no-op (a live-capture client's
        # silence gap / device hiccup must not tear down the session).
        body = self._read_body(required=False)
        if len(body) % 4:
            raise ValueError(
                f"body is {len(body)} bytes; expected raw <f4 PCM "
                "(a multiple of 4)"
            )
        pcm = np.frombuffer(body, "<f4")
        with session.lock:
            emb = session.embedder.feed(pcm)
        self._reply_rows(emb)

    def _stream_flush(self, sid: str):
        self._read_body(required=False)  # drain any (ignored) body
        session = self.state.get_stream(sid)
        with session.lock:
            emb = session.embedder.flush()
        self.state.close_stream(sid)
        self._reply_rows(emb)

    def _embed_windows_raw(self):
        st = self.state
        n = int(self.headers.get("X-Num-Windows", 0))
        if n <= 0:
            raise ValueError("X-Num-Windows header required and positive")
        body = self._read_body()
        win = st.window_samples
        expect = n * win * 4
        if len(body) != expect:
            raise ValueError(
                f"body is {len(body)} bytes; expected {expect} for "
                f"{n}x{win} float32"
            )
        windows = np.frombuffer(body, "<f4").reshape(n, win)
        emb = np.asarray(
            st.service.submit(windows).result(), np.float32
        )
        self._reply_rows(emb)


def make_server(
    extractor: EmbeddingExtractor,
    host: str = "127.0.0.1",
    port: int = 8471,
    max_batch_size: int = 128,
    max_latency_ms: float = 5.0,
    pipeline_depth: int = 2,
) -> ThreadingHTTPServer:
    """Build (but don't start) the HTTP server around an extractor."""
    service = EmbeddingService(
        extractor,
        max_batch_size=max_batch_size,
        max_latency_ms=max_latency_ms,
        pipeline_depth=pipeline_depth,
    )
    state = _State(extractor, service)
    handler = type("BoundHandler", (_Handler,), {"state": state})
    # socketserver's default listen backlog is 5: a burst of concurrent
    # clients (the whole point of micro-batched serving) gets connection
    # resets before the accept loop ever sees them. 128 matches the
    # service's max batch.
    server_cls = type(
        "L3HTTPServer", (ThreadingHTTPServer,), {"request_queue_size": 128}
    )
    server = server_cls((host, port), handler)
    server.l3_service = service  # for shutdown/tests
    return server


def serve_forever_in_thread(server: ThreadingHTTPServer) -> threading.Thread:
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return t


def parse_args(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("weights", nargs="?", default=None,
                   help=".ckpt weights (omit for random init / smoke)")
    p.add_argument("--model-type", default="cnn_L3_melspec2")
    p.add_argument("--pooling", default="short", choices=["original", "short"])
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8471)
    p.add_argument("--fast", action="store_true", help="bf16 tower")
    p.add_argument("--max-batch-size", type=int, default=128)
    p.add_argument("--max-latency-ms", type=float, default=5.0)
    p.add_argument("--pipeline-depth", type=int, default=2,
                   help="device batches in flight: >1 overlaps result "
                        "readback with the next batch's compute (1 = synchronous)")
    p.add_argument("--mesh", action="store_true",
                   help="replicate the model on every visible card and split "
                        "each window batch over them")
    p.add_argument("--int8", action="store_true",
                   help="serve the int8 post-training-quantized tower "
                        "(embed/quantized.py); requires --int8-calib")
    p.add_argument("--int8-calib", default=None,
                   help="directory of representative .wav files used to "
                        "calibrate int8 activation scales at startup")
    p.add_argument("--int8-calib-files", type=int, default=32,
                   help="number of calibration files, sampled evenly "
                        "across the sorted file list")
    p.add_argument("--int8-min-cosine", type=float, default=0.999,
                   help="refuse to serve if the int8 tower's measured min "
                        "cosine vs the BN-folded f32 tower on the "
                        "calibration windows is below this. 0 disables the gate")
    p.add_argument("--int8-calib-method", choices=["amax", "percentile"],
                   default="amax",
                   help="clip activation scales at the absolute max or "
                        "the 99.99th percentile of |activations|")
    p.add_argument("--int8-artifact", default=None,
                   help="serve a pre-calibrated int8 artifact (save_artifact "
                        "output of either package): no f32 checkpoint or "
                        "calibration wavs needed; the accuracy gate recorded "
                        "at export is re-checked against --int8-min-cosine")
    p.add_argument("--int8-save-artifact", default=None,
                   help="after --int8-calib calibration, export the "
                        "quantized tower to this .npz so later starts "
                        "can use --int8-artifact")
    p.add_argument("--int8-dft-bf16", action="store_true",
                   help="keep the front end's DFT in bf16 (the front-end "
                        "kernel) instead of the default s8xs8->s32 stage for "
                        "mel towers. Artifact loads ignore this: the artifact "
                        "records the front end it was gated with")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain versions)")
    args = p.parse_args(argv)
    if args.int8 and not args.int8_artifact and not args.int8_calib:
        p.error("--int8 requires --int8-calib DIR (.wav files) or --int8-artifact FILE")
    return args


def build_extractor(args):
    """The extractor the flags ask for: an int8 artifact, an int8 tower
    calibrated on --int8-calib (and saved with --int8-save-artifact), or
    the f32 / bf16 tower."""
    import glob
    import os

    from .quantized import QuantizedEmbeddingExtractor

    devices = None
    if args.mesh:
        import torch

        n = torch.cuda.device_count()
        if n == 0:
            raise SystemExit("--mesh needs at least one visible CUDA device")
        devices = [f"cuda:{i}" for i in range(n)]
    gate = args.int8_min_cosine if args.int8_min_cosine > 0 else None
    if args.int8_artifact:
        LOGGER.info("loading int8 artifact %s", args.int8_artifact)
        return QuantizedEmbeddingExtractor.load_artifact(
            args.int8_artifact, devices=devices, min_cosine=gate, device=args.device)
    if args.int8:
        wavs = sorted(glob.glob(os.path.join(args.int8_calib, "**", "*.wav"), recursive=True))
        if not wavs:
            raise SystemExit(f"no .wav files under --int8-calib {args.int8_calib}")
        extractor = QuantizedEmbeddingExtractor(
            args.weights, args.model_type, args.pooling, devices=devices,
            dft_int8=False if args.int8_dft_bf16 else None, device=args.device,
        )
        # Evenly across the sorted list: a prefix of a class-per-directory
        # tree would calibrate on one class only.
        n = min(args.int8_calib_files, len(wavs))
        calib = wavs[:: max(1, len(wavs) // n)][:n]
        LOGGER.info("calibrating int8 scales on %d of %d files", len(calib), len(wavs))
        extractor.calibrate_files(calib, method=args.int8_calib_method, min_cosine=gate)
        if args.int8_save_artifact:
            extractor.save_artifact(args.int8_save_artifact)
        return extractor
    return EmbeddingExtractor(
        args.weights, args.model_type, args.pooling,
        fast=args.fast, devices=devices, device=args.device,
    )


def main(argv=None):
    args = parse_args(argv)
    # Logging before the extractor: the int8 paths log the calibration set
    # and the measured gate while it is built.
    logging.basicConfig(level=logging.INFO)
    extractor = build_extractor(args)
    server = make_server(
        extractor, args.host, args.port,
        max_batch_size=args.max_batch_size,
        max_latency_ms=args.max_latency_ms,
        pipeline_depth=args.pipeline_depth,
    )
    LOGGER.info(
        "serving %s/%s embeddings on http://%s:%d (%s)",
        extractor.model_type, extractor.pooling_type, args.host, args.port,
        ", ".join(str(d) for d in extractor._replicas),
    )
    # Graceful drain on SIGTERM (orchestrators send it before SIGKILL):
    # stop accepting, let in-flight requests finish through the pipelined
    # service, exit 0.
    import signal

    def _term(signum, frame):
        LOGGER.info("SIGTERM: draining and shutting down")
        threading.Thread(target=server.shutdown, daemon=True).start()

    try:
        signal.signal(signal.SIGTERM, _term)
    except ValueError:  # not the main thread (embedded use)
        pass
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        # Serve what was already accepted (bounded), then stop the
        # micro-batching threads; close() fails anything still queued
        # loudly rather than leaving callers hanging on a dead server.
        server.l3_service.drain(timeout=10.0)
        server.l3_service.close()
        server.server_close()
        LOGGER.info("shutdown complete (%s requests served)",
                    server.l3_service.stats_snapshot()["requests"])


if __name__ == "__main__":
    main()
