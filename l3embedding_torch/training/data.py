"""Training input pipeline: batches streamed out of the HDF5 blob files of
``02_generate_samples.py`` (a jax-free copy of
``l3embedding_tpu/training/data.py``, reference l3embedding/train.py:134-195).

Files are cycled in seeded shuffle order, batches are assembled across
blob boundaries, and ``start_batch_idx`` fast-forwards deterministically
for resume, reading only blob lengths for the skipped range. Batches stay
in their storage dtypes (uint8 video, int16 audio): the float conversion
happens on the device inside the step. ``AsyncBatchPipeline`` overlaps the
reads with device work through a background thread and a bounded queue;
``to_device`` uploads a batch from pinned memory without blocking.

``h5py`` is imported where a file is opened, so that the module imports on
a machine without it; reading a corpus there raises ImportError.
"""

from __future__ import annotations

import os
import queue
import random
import threading

import numpy as np
import torch

DEFAULT_KEYS = ("audio", "video", "label")


def cycle_shuffle(iterable, shuffle=True, rng=None):
    """Yield items forever, reshuffling after each pass
    (reference train.py:134-139)."""
    rng = rng or random
    lst = list(iterable)
    while True:
        yield from lst
        if shuffle:
            rng.shuffle(lst)


def data_generator(
    data_dir,
    batch_size=512,
    random_state=20180123,
    start_batch_idx=None,
    keys=None,
    shard_index=0,
    shard_count=1,
):
    """Yields dict batches of exactly batch_size, concatenated across blob
    files, in seeded cycle_shuffle order. Raw dtypes (no float conversion).

    shard_index/shard_count partition the corpus for multi-host data
    parallelism: each process reads the disjoint file subset
    ``files[shard_index::shard_count]`` and shuffles it with a
    per-shard-offset seed, so a pod feeds its hosts without any
    coordination or duplicated reads (the reference is single-host only,
    training_utils.py:21-170; this is the pod extension of its worker
    seeding convention, 02_generate_samples.py:120-141 /
    sample.py:578). `batch_size` stays the PER-PROCESS size: callers
    pass global_batch // process_count.
    """
    if not 0 <= shard_index < shard_count:
        raise ValueError(
            f"shard_index {shard_index} not in [0, {shard_count})"
        )
    rng = random.Random(random_state + shard_index)
    keys = list(keys) if keys else list(DEFAULT_KEYS)

    parts = []  # list of per-key dict chunks
    curr = 0
    batch_idx = 0

    # The reference iterates os.listdir unfiltered (train.py:147) — a
    # stray non-HDF5 file would crash hours into training, and an empty
    # directory would busy-loop forever. Filter and fail fast instead;
    # ordering for valid corpora is unchanged.
    file_list = sorted(
        f for f in os.listdir(data_dir) if f.endswith((".h5", ".hdf5"))
    )
    if shard_count > 1:
        file_list = file_list[shard_index::shard_count]
        if not file_list:
            raise ValueError(
                f"corpus {data_dir!r} has fewer .h5 files than "
                f"shard_count={shard_count} (shard {shard_index} is empty)"
            )
    if not file_list:
        raise ValueError(f"no .h5 batch files in {data_dir!r}")
    import h5py

    for fname in cycle_shuffle(file_list, rng=rng):
        path = os.path.join(data_dir, fname)
        with h5py.File(path, "r") as blob:
            blob_size = len(blob["label"])
            start = 0
            while start < blob_size:
                end = min(start + batch_size - curr, blob_size)
                live = start_batch_idx is None or batch_idx >= start_batch_idx
                if live:
                    parts.append({k: blob[k][start:end] for k in keys})
                curr += end - start
                start = end
                if curr == batch_size:
                    if live:
                        if len(parts) == 1:
                            yield parts[0]
                        else:
                            yield {
                                k: np.concatenate([p[k] for p in parts])
                                for k in keys
                            }
                    batch_idx += 1
                    curr = 0
                    parts = []


def single_epoch_data_generator(data_dir, epoch_size, **kwargs):
    """Restarts the (identically seeded) stream every epoch_size batches —
    the reference's validation-stream behavior (train.py:198-205)."""
    while True:
        gen = data_generator(data_dir, **kwargs)
        for idx, item in enumerate(gen):
            yield item
            if (idx + 1) == epoch_size:
                break


class AsyncBatchPipeline:
    """Background-thread prefetcher over any batch generator.

    Keeps up to `prefetch` host batches queued so HDF5/decode latency
    overlaps device compute. Call `close()` (or use as context manager)
    to stop the worker.
    """

    def __init__(self, generator, prefetch: int = 4):
        self._gen = generator
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._exc = None
        self._done = False
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            for item in self._gen:
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.25)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
        except BaseException as e:  # surfaced on next __next__
            self._exc = e
        finally:
            # Bounded sentinel put: after close() drains the queue a
            # blocking put(None) could hang forever (nobody consumes),
            # leaving close() to eat the full join timeout.
            while not self._stop.is_set():
                try:
                    self._q.put(None, timeout=0.25)
                    break
                except queue.Full:
                    continue

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            # Keep the iterator protocol after exhaustion (the single
            # sentinel is consumed once; a second get() would block on an
            # empty queue with the worker already gone).
            if self._exc is not None:
                raise self._exc
            raise StopIteration
        item = self._q.get()
        if item is None:
            self._done = True
            if self._exc is not None:
                raise self._exc
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        # Join the worker: a daemon thread still inside an h5py read at
        # interpreter exit deadlocks against HDF5's atexit cleanup (global
        # lock), hanging the process. The worker notices _stop at its next
        # queue.put attempt, so this returns promptly.
        self._thread.join(timeout=30)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def to_device(batch: dict, device: str | torch.device) -> dict:
    """numpy batch → tensors on `device`. On the card each array is copied
    into pinned memory and uploaded with non_blocking=True on the calling
    thread's current stream (torch's caching host allocator keeps the
    pinned block until the copy is done)."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t
    return out
