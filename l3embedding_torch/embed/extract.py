"""Windowed embedding extraction (port of ``l3embedding_tpu/embed/extract.py``).

Files are framed into overlapping 1 s windows with the reference's
centering/padding math, and window batches are zero-padded up to a
power-of-two bucket, as in the JAX package, so a batch's rows do not
depend on how many real windows share it, even under the batch-global
dB quirk (zero rows sit at the −100 dB amin floor). The padding rows are
made on the device: only real rows cross to it.

Two ways to frame a clip:

  * host framing (``frame_uniform``): the windows are cut on the host and
    uploaded, each sample ~1/hop times over;
  * device framing (``device_framing=True``,
    ``EmbeddingExtractor._embed_device_framed``): the clip's PCM is
    uploaded once and the windows are cut on the device.

Uploads go through pinned host buffers with non-blocking copies on the
extractor's stream, and results come back through a pinned host tensor
and an event (``EmbeddingRows``), so a caller can dispatch batch k+1
while batch k is still computing or copying back.
"""

from __future__ import annotations

import contextlib
import copy
import json
import threading
from typing import Sequence

import numpy as np
import torch

from ..compat.from_jax import from_jax_variables
from ..models.embedding import audio_embedding_fn
from ..training.checkpoints import load_variables
from ..utils import trace

BUCKETS = (16, 32, 64, 128, 256, 512)
INIT_SEED = 0


def frame_uniform(audio: np.ndarray, sr: int = 48000, hop_size: float = 0.1):
    """Overlapping 1 s windows with the reference's centering/padding
    (reference features.py:256-301) → (num_windows, frame_length) f32."""
    hop_length = int(hop_size * sr)
    frame_length = sr * 1

    audio_length = len(audio)
    if audio_length < frame_length:
        pad_length = frame_length - audio_length
    else:
        # Reference quirk kept on purpose (features.py:288): the ceil is
        # applied to the *difference*, a no-op on an integer, so a
        # non-hop-aligned clip loses its trailing partial window. Row
        # counts then align file for file with reference feature sets.
        pad_length = (
            int(np.ceil(audio_length - frame_length) / hop_length) * hop_length
            - (audio_length - frame_length)
        )
    if pad_length > 0:
        left = pad_length // 2
        audio = np.pad(audio, (left, pad_length - left), mode="constant")

    n = (len(audio) - frame_length) // hop_length + 1
    strides = (audio.strides[0] * hop_length, audio.strides[0])
    return np.lib.stride_tricks.as_strided(
        audio, shape=(n, frame_length), strides=strides
    ).astype(np.float32)


def _bucket(n: int, buckets: Sequence[int] | None = None) -> int:
    """The smallest of `buckets` (default BUCKETS) that holds n rows, or
    the next multiple of the largest."""
    buckets = buckets or BUCKETS
    for b in buckets:
        if n <= b:
            return b
    return int(np.ceil(n / buckets[-1])) * buckets[-1]


def replica_devices(devices, device, db_batch_global: bool):
    """(devices as torch.device or None, the replica devices): `devices`
    when given, else [device]; only the first under db_batch_global, whose
    dB reference spans the whole bucket."""
    devices = None if devices is None else [torch.device(d) for d in devices]
    if devices is not None and not devices:
        raise ValueError("devices: need at least one device")
    replicas = devices or [torch.device(device)]
    return devices, replicas[:1] if db_batch_global else replicas


def split_bucket(n: int, n_devices: int) -> int:
    """The bucket of n windows rounded up to a multiple of the device count,
    so that it splits into equal chunks (which need not be a power of two)."""
    return -(-_bucket(n) // n_devices) * n_devices


class EmbeddingRows:
    """Handle of an asynchronous extraction: the (n, dim) rows (a Whisper
    extractor's (n, frames, dim)), copied (or being copied) into a host
    tensor. On a card the host tensor is pinned,
    owned by this handle, and filled by non-blocking copies, with one CUDA
    event recorded behind each copy; ``result()`` waits on those events (not
    on the whole device) and returns the rows as a new numpy array, or, with
    copy=False, as a numpy view of the pinned tensor, which goes back to
    torch's pinned cache once the view is gone. Use ``result()``:
    ``np.asarray`` of the handle is not supported."""

    def __init__(self, host: torch.Tensor, events: Sequence = (), copy: bool = True):
        self._host = host
        self._events = list(events)
        self._copy = copy

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self._host.shape)

    def result(self) -> np.ndarray:
        for event in self._events:
            event.synchronize()
        if self._events and self._copy:
            return self._host.numpy().copy()
        return self._host.numpy()


class EmbeddingExtractor:
    """Batched audio-embedding extractor for one (model_type, pooling) of
    any of the five model types, holding the tower's weights resident on
    `device`.

    weights_path: a ``.ckpt`` written by the JAX package
    (``training/checkpoints.save_variables``; an AVC checkpoint or an
    exported audio tower), or None for a random model: He-normal conv
    kernels drawn from a ``torch.Generator`` seeded with INIT_SEED. That
    init is reproducible but is not flax's: the numbers differ from the
    JAX extractor's random init.
    fast=True runs the bf16 tower (bf16 kernel front end and convs;
    tiny_L3 stays f32, as in the JAX package); False keeps the f32 parity
    configuration.
    db_batch_global=True reproduces kapre<=0.1.x's batch-global dB quirk.
    devices: the JAX package's ``mesh`` for serving over several devices:
    the model is replicated on each, and every bucket, rounded up to a
    multiple of the device count, is split over them in equal chunks.
    It forces host framing (as a mesh does in JAX). Under db_batch_global
    the dB reference is a max over the whole bucket (JAX's sharded jit
    keeps it so), and the front-end kernel takes that max within one
    launch, so the model sits on the first device only and every bucket
    runs whole there: the rows are the mesh's, without the split. With
    devices=None the extractor runs on `device`.
    device_framing=True makes embed_audio upload a clip's PCM once and cut
    the windows on the device (clips shorter than one window, and
    extractors with `devices`, frame on the host).

    Every call runs on the stream that was current on each device when the
    extractor was built, whichever thread makes the call.
    """

    # result() hands out a copy of the pinned rows, so that rows a caller
    # keeps do not keep pinned memory.
    copy_rows = True
    # The rows' copy to the host runs on the call's own stream; True puts it
    # on a second stream of the device, behind the forward, so that it
    # overlaps the next call's forward.
    side_download = False

    def __init__(
        self,
        weights_path: str | None,
        model_type: str,
        pooling_type: str = "original",
        sr: int = 48000,
        fast: bool = False,
        db_batch_global: bool = False,
        devices: Sequence[str | torch.device] | None = None,
        device_framing: bool = False,
        device: str | torch.device = "cuda",
    ):
        devices, replicas = replica_devices(devices, device, db_batch_global)
        model = audio_embedding_fn(
            model_type,
            pooling_type,
            compute_dtype=torch.bfloat16 if fast else torch.float32,
            db_batch_global=db_batch_global,
        )
        if weights_path is None:
            model.tower.reset_parameters(torch.Generator().manual_seed(INIT_SEED))
        else:
            model.tower.load_state_dict(
                from_jax_variables(load_variables(weights_path), model_type)
            )
        model = model.eval()
        models = [copy.deepcopy(model).to(d) for d in replicas[1:]]
        models.insert(0, model.to(replicas[0]))
        self._bind(models, replicas, devices, model_type, pooling_type, sr, device_framing)

    def _bind(self, models, replicas, devices, model_type, pooling_type, sr, device_framing):
        """Hold `models`, one per replica device (each maps (B, 1, n) PCM to
        (B, dim) rows), and the state every call uses."""
        self.model_type = model_type
        self.pooling_type = pooling_type
        self.sr = sr
        self.devices = devices
        self.device = replicas[0]
        self.models = list(models)
        self.model = self.models[0]
        self._replicas = replicas
        self._streams = [torch.cuda.current_stream(d) if d.type == "cuda" else None for d in replicas]
        self._download_streams = [torch.cuda.Stream(d) if s is not None and self.side_download else s
                                  for d, s in zip(replicas, self._streams)]
        self.device_framing = bool(device_framing)
        self.bytes_uploaded = 0  # host→device bytes of PCM and windows, over the extractor's life
        self._count_lock = threading.Lock()

    def _on_stream(self, i: int):
        stream = self._streams[i]
        return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()

    def _upload(self, dst: torch.Tensor, src: np.ndarray, i: int) -> None:
        """dst (on replica i's device) ← src, a contiguous float32 array,
        without synchronising: through a pinned host buffer from PyTorch's
        caching host allocator, which records an event on the stream behind
        the non-blocking copy and hands the buffer out again only after that
        event has completed."""
        with self._count_lock:
            self.bytes_uploaded += src.nbytes
        if dst.device.type != "cuda":
            dst.copy_(torch.from_numpy(src))
            return
        staged = torch.empty(src.shape, dtype=torch.float32, pin_memory=True)
        staged.copy_(torch.from_numpy(src))  # torch's CPU copy runs on several threads
        with torch.cuda.stream(self._streams[i]):
            dst.copy_(staged, non_blocking=True)

    def _forward_rows(self, chunks: list, n: int) -> EmbeddingRows:
        """One (rows, samples) window tensor per replica → the first n rows
        of their embeddings (each row (dim,), or any shape the model gives a
        window), copied back into one host tensor. Counts the call's
        real rows and the rows the towers compute (``rows``, ``bucket_rows``
        of the ``extract.call`` span)."""
        if trace.on():
            trace.count("extract.call", rows=n, bucket_rows=sum(x.shape[0] for x in chunks))
        outs = []
        with trace.span("extract.forward"):
            for i, x in enumerate(chunks):
                with self._on_stream(i):
                    outs.append(self.models[i](x[:, None, :]))  # (B, 1, samples) reference input convention
        if all(out.device.type == "cpu" for out in outs):
            return EmbeddingRows((outs[0] if len(outs) == 1 else torch.cat(outs))[:n])
        with trace.span("extract.download"):
            host = torch.empty((n, *outs[0].shape[1:]), dtype=torch.float32, pin_memory=True)
            events, start = [], 0
            for i, out in enumerate(outs):
                rows = min(out.shape[0], n - start)
                if rows > 0:
                    stream = self._download_streams[i]
                    if stream is not self._streams[i]:
                        stream.wait_stream(self._streams[i])
                        out.record_stream(stream)
                    with torch.cuda.stream(stream):
                        host[start : start + rows].copy_(out[:rows], non_blocking=True)
                        event = torch.cuda.Event()
                        event.record(stream)
                        events.append(event)
                start += out.shape[0]
        return EmbeddingRows(host, events, copy=self.copy_rows)

    def _embed_device_framed(self, audio: np.ndarray, hop_size: float) -> EmbeddingRows:
        """Framing on the device, as ``l3embedding_tpu/embed/extract.py::_DeviceFramer``.

        A clip's PCM crosses to the device once, into a buffer of exactly
        the samples the bucket's windows cover, zeros beyond the clip; the
        windows are an ``unfold`` view of it. Rows equal the host-framed
        path's: the bucket-padding rows are zeroed on the device, because
        the buffer's padding windows overlap the clip's real trailing PCM,
        and under the batch-global dB quirk the dB reference is a max over
        the whole batch, so a loud non-hop-aligned tail seen only by
        padding rows would shift every real row. The zeroed rows match the
        host path's zero rows."""
        sr, dev = self.sr, self.device
        hop_length = int(hop_size * sr)
        n = (len(audio) - sr) // hop_length + 1
        bucket = _bucket(n)
        # Stage exactly the samples the bucket's windows cover: real PCM for
        # the n true windows (a dropped non-hop-aligned tail matches
        # frame_uniform's reference quirk), zeros beyond.
        need = (bucket - 1) * hop_length + sr
        m = min(len(audio), need)
        with self._on_stream(0):
            with trace.span("extract.upload"):
                buf = torch.zeros(need, dtype=torch.float32, device=dev)
                self._upload(buf[:m], np.ascontiguousarray(audio[:m], dtype=np.float32), 0)
                windows = buf.unfold(0, sr, hop_length)  # (bucket, sr) view
                keep = (torch.arange(bucket, device=dev) < n)[:, None]
                windows = torch.where(keep, windows, buf.new_zeros(())).contiguous()
            return self._forward_rows([windows], n)

    def _bucket_size(self, n: int) -> int:
        """Rows a batch of n windows is padded to: its bucket, rounded up to
        a multiple of the device count with `devices`."""
        return _bucket(n) if self.devices is None else split_bucket(n, len(self._replicas))

    def embed_windows_async(self, windows) -> EmbeddingRows:
        """Dispatch (N, frame_length) windows without synchronising; returns
        an EmbeddingRows handle, whose ``result()`` gives the (N, dim) rows.

        The bucket's zero rows are made on the device; only the N real rows
        are uploaded. With `devices` the bucket is split over them (under
        db_batch_global it runs whole on the first). One ``extract.call``
        span while tracing is on."""
        with trace.span("extract.call", self._streams[0]):
            with trace.span("extract.upload"):
                windows = np.ascontiguousarray(windows, dtype=np.float32)
                n, width = windows.shape
                k = len(self._replicas)
                chunk = self._bucket_size(n) // k
                chunks = []
                for i, dev in enumerate(self._replicas):
                    real = windows[i * chunk : (i + 1) * chunk]
                    with self._on_stream(i):
                        x = torch.zeros((chunk, width), dtype=torch.float32, device=dev)
                        if len(real):
                            self._upload(x[: len(real)], real, i)
                    chunks.append(x)
            return self._forward_rows(chunks, n)

    def embed_windows(self, windows) -> np.ndarray:
        """(N, frame_length) float32 → (N, dim) embeddings."""
        return self.embed_windows_async(windows).result()

    def embed_audio_async(self, audio: np.ndarray, hop_size: float = 0.1,
                          device_framing: bool | None = None) -> EmbeddingRows:
        """embed_audio without the sync: framing (on the host or the
        device) and dispatch happen now, ``result()`` materialises. One
        ``extract.call`` span while tracing is on."""
        with trace.span("extract.call", self._streams[0]):
            audio = np.asarray(audio, dtype=np.float32)
            use_device = self.device_framing if device_framing is None else device_framing
            if use_device and self.devices is None and len(audio) >= self.sr:
                # Clips shorter than one window take the host path: they need
                # the centered zero-padding and are one window anyway.
                return self._embed_device_framed(audio, hop_size)
            with trace.span("extract.upload"):
                windows = frame_uniform(audio, self.sr, hop_size)
            return self.embed_windows_async(windows)

    def embed_audio(self, audio: np.ndarray, hop_size: float = 0.1,
                    device_framing: bool | None = None) -> np.ndarray:
        """A mono clip at self.sr → one embedding row per window."""
        return self.embed_audio_async(audio, hop_size, device_framing).result()

    def embed_file(self, path: str, hop_size: float = 0.1) -> np.ndarray:
        from ..data.audio_io import load_audio

        return self.embed_audio(load_audio(path, self.sr), hop_size=hop_size)


def load_exported_embedding(prefix: str, **kwargs) -> EmbeddingExtractor:
    """Rebuild a resident extractor from ``tools/export_embedding_model.py``
    output: ``<prefix>.json`` (model type, pooling, dB quirk) and
    ``<prefix>.ckpt`` (the audio tower's params and batch_stats only).
    kwargs (fast, devices, device_framing, device) go to the extractor."""
    with open(prefix + ".json") as f:
        desc = json.load(f)
    if desc.get("export") != "audio":
        raise ValueError(
            f"exported artifact is {desc.get('export')!r}; the resident "
            "extractor serves audio embeddings — use "
            "models.vision_embedding_fn with the .ckpt for vision"
        )
    return EmbeddingExtractor(
        prefix + ".ckpt",
        desc["model_type"],
        desc["pooling_type"],
        db_batch_global=bool(desc.get("db_batch_global", False)),
        **kwargs,
    )
