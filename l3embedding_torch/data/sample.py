"""AVC sample factory: paired (1 s audio, 1 video frame) examples → HDF5
(port of ``l3embedding_tpu/data/sample.py``; reference
data/avc/sample.py:117-595).

  * Per streamer: two decoded videos + audios; each sample flips two fair
    coins to pick the audio/video source — label = [mismatch, match]
    one-hot (reference sample.py:346-375).
  * 1 s audio window sampled uniformly; short audio zero-padded; optional
    ±10% gain augmentation clamped against int16 clipping
    (reference sample.py:117-166).
  * One frame from the same 1 s window; random 224×224 crop; optional
    horizontal flip + saturation/brightness jitter applied in random
    order with Inception-style ranges (reference sample.py:169-283), on the
    native host library (``l3embedding_torch/native.py``).
  * ``StreamMux`` replaces pescador.Mux: k concurrent streamers, each with
    a Poisson(rate) sample budget, uniform choice among active streams,
    exhausted or dead streams replaced from the (cycled) seed list.
  * Batches written one per HDF5 file: 'audio' (N, 1, 48000) int16,
    'video' (N, 224, 224, 3) uint8, 'label' (N, 2) int64 one-hot, plus
    the metadata keys with ``include_metadata`` (file names as bytes).

Random draws. The JAX package seeds the interpreter's global ``random``
and ``np.random`` in ``data_generator``; here ``data_generator`` makes one
``random.Random(random_state)`` and threads it through every draw, and the
mux keeps its own ``np.random.RandomState(random_state)``. The order of
the draws is JAX's (the two coins, the audio start, the gain, the frame,
the crop, then flip, ``sat_first`` and the jitter in the order it picks),
so one seed gives JAX's batches bit for bit, and the caller's global
generators are not touched. The sampling functions take ``rng=None`` to
mean the global ``random`` module, as JAX's do.

``h5py`` is imported inside ``write_to_h5``, so that the module imports on
a machine without it.
"""

from __future__ import annotations

import logging
import os
import random
import warnings

import numpy as np

from .. import native
from ..ops.image import img_as_float, img_as_ubyte
from ..utils.log import LogTimer
from .audio_io import read_audio, to_mono_int16
from .utils import flatten_dict, read_csv_as_dicts
from .video_io import read_video

LOGGER = logging.getLogger("l3embedding_torch.sampling")
LOGGER.setLevel(logging.ERROR)


def get_max_abs_sample_value(dtype) -> float:
    dtype = np.dtype(dtype)
    if dtype.kind == "i":
        return float(2 ** (8 * dtype.itemsize - 1))
    if dtype.kind == "f":
        return 1.0
    raise ValueError(f"unsupported audio dtype {dtype}")


def augment_gain(audio_data, rng=None):
    """±10 % gain, its upper end clamped so the peak cannot clip → (audio in
    its own dtype, gain) (reference sample.py:146-161)."""
    rng = rng or random
    orig_dtype = audio_data.dtype
    audio_data = audio_data.astype(float)
    if np.abs(audio_data).max():
        max_gain = min(0.1, get_max_abs_sample_value(orig_dtype) / np.abs(audio_data).max() - 1)
    else:
        warnings.warn("Got audio sample with all zeros", UserWarning)
        max_gain = 0.1
    gain = 1 + rng.uniform(-0.1, max_gain)
    assert 0.9 <= gain <= 1.1
    return (audio_data * gain).astype(orig_dtype), gain


def pad_to_one_second(audio_data, sampling_frequency):
    if audio_data.shape[0] != sampling_frequency:
        warnings.warn("Got audio that is less than one second", UserWarning)
        audio_data = np.pad(
            audio_data, ((0, sampling_frequency - audio_data.shape[0]),), mode="constant")
    return audio_data


def sample_one_second(audio_data, sampling_frequency, augment=False, rng=None):
    """Random 1 s slice (+ optional gain augment) → (samples, start_sec,
    aug_params). Reference sample.py:117-166."""
    rng = rng or random
    sampling_frequency = int(sampling_frequency)
    if len(audio_data) > sampling_frequency:
        start = rng.randrange(len(audio_data) - sampling_frequency)
    else:
        start = 0

    audio_data = pad_to_one_second(audio_data[start : start + sampling_frequency], sampling_frequency)
    aug_params = {}
    if augment:
        audio_data, gain = augment_gain(audio_data, rng)
        aug_params = {"gain": gain}
    return audio_data, start / float(sampling_frequency), aug_params


def sample_cropped_frame(frame_data, rng=None):
    """Random 224×224 crop (reference sample.py:169-193).

    A frame with a side exactly 224 has one valid crop position (the
    reference's bare randrange(0) crashes there, sample.py:182); the
    max(1, ...) keeps the number of draws the same for every larger frame.
    Sides < 224 raise (a dead streamer for the sampler)."""
    rng = rng or random
    nx, ny, _ = frame_data.shape
    if nx < 224 or ny < 224:
        raise ValueError(f"frame {(nx, ny)} smaller than the 224x224 crop")
    start_x = rng.randrange(max(1, nx - 224))
    start_y = rng.randrange(max(1, ny - 224))
    bbox = {"start_x": start_x, "start_y": start_y}
    return frame_data[start_x : start_x + 224, start_y : start_y + 224, :], bbox


def sample_one_frame(video_data, start=None, fps=30, augment=False, rng=None):
    """Random frame from the 1 s window at `start` seconds, cropped and
    optionally augmented → (uint8 frame, frame_idx, aug_params).
    Reference sample.py:196-283."""
    rng = rng or random
    num_frames = len(video_data)
    if start is not None:
        start_frame = int(start * fps)
        duration = min(fps, num_frames - start_frame)
        if duration != fps:
            warnings.warn("Got video that is less than one second", UserWarning)
        if duration > 0:
            frame = start_frame + rng.randrange(duration)
        else:
            warnings.warn("Got video with only a single frame", UserWarning)
            frame = min(start_frame, num_frames - 1)
    else:
        frame = rng.randrange(num_frames)

    frame_data, bbox = sample_cropped_frame(video_data[frame], rng)
    aug_params = {"bounding_box": bbox}

    if augment:
        # Inception-preprocessing jitter ranges, saturation and brightness
        # in random order (reference sample.py:240-271); each parameter is
        # rounded to float32 as the JAX package does.
        horizontal_flip = rng.random() < 0.5
        sat_first = rng.random() < 0.5
        if sat_first:
            saturation_factor = np.float32(rng.random() + 0.5)
            brightness_delta = np.float32((2 * rng.random() - 1) * (32.0 / 255.0))
        else:
            brightness_delta = np.float32((2 * rng.random() - 1) * (32.0 / 255.0))
            saturation_factor = np.float32(rng.random() + 0.5)

        frame_data = native.augment_frame(
            frame_data, flip=horizontal_flip, saturation_factor=float(saturation_factor),
            brightness_delta=float(brightness_delta), sat_first=sat_first)
        aug_params.update({
            "horizontal_flip": horizontal_flip,
            "saturation_factor": saturation_factor,
            "brightness_delta": brightness_delta,
        })
    else:
        frame_data = img_as_ubyte(img_as_float(frame_data))

    return frame_data, frame, aug_params


def generate_sample(
    audio_file_1, audio_data_1, audio_file_2, audio_data_2,
    video_file_1, video_data_1, video_file_2, video_data_2,
    audio_sampling_frequency, augment=False, include_metadata=False, rng=None,
):
    """One AVC example via two fair coins (reference sample.py:319-387)."""
    rng = rng or random
    video_choice = rng.random() < 0.5
    audio_choice = rng.random() < 0.5

    audio_file, audio_data = (
        (audio_file_1, audio_data_1) if audio_choice else (audio_file_2, audio_data_2))
    video_file, video_data = (
        (video_file_1, video_data_1) if video_choice else (video_file_2, video_data_2))
    label = int(video_choice != audio_choice)

    sample_audio_data, audio_start, audio_aug_params = sample_one_second(
        audio_data, audio_sampling_frequency, augment=augment, rng=rng)
    sample_video_data, video_start, video_aug_params = sample_one_frame(
        video_data, start=audio_start, augment=augment, rng=rng)

    sample = {
        "video": np.ascontiguousarray(sample_video_data),
        "audio": np.ascontiguousarray(sample_audio_data.reshape((1, sample_audio_data.shape[0]))),
        "label": np.ascontiguousarray(np.array([label, 1 - label])),
    }
    if include_metadata:
        sample["audio_file"] = os.path.basename(audio_file).encode("utf-8")
        sample["video_file"] = os.path.basename(video_file).encode("utf-8")
        # The sample index, not seconds: the reference stores seconds here
        # while its repair tool reads a sample index (reference
        # sample.py:383 vs recompute_batch_audio.py:71); the JAX package's
        # repair, kept, makes the round trip exact.
        sample["audio_start_sample_idx"] = int(round(audio_start * audio_sampling_frequency))
        sample["video_start_frame_idx"] = video_start
        sample.update(flatten_dict(audio_aug_params, "audio"))
        sample.update(flatten_dict(video_aug_params, "video"))
    return sample


class StreamerDead(Exception):
    """Raised when a streamer's source files cannot be decoded."""


def sampler(video_1, video_2, rate=32, augment=False, precompute=False,
            include_metadata=False, rng=None):
    """Infinite generator of AVC samples for one (video, distractor) pair
    (reference sample.py:390-504). Raises StreamerDead on a decode failure
    or on a clip it cannot sample from (frames under 224 px), so the mux
    replaces it."""
    video_file_1 = video_1["video_filepath"]
    video_file_2 = video_2["video_filepath"]
    audio_file_1 = video_1["audio_filepath"]
    audio_file_2 = video_2["audio_filepath"]

    def _dead(path, what, e):
        msg = f"Could not open {what} file {path} - {type(e)}: {e}; Skipping..."
        LOGGER.warning(msg)
        warnings.warn(msg)
        return StreamerDead(path)

    def _read_video(path):
        try:
            with LogTimer(LOGGER, "Reading video"):
                return read_video(path)
        except Exception as e:
            raise _dead(path, "video", e) from e

    def _read_audio(path):
        try:
            with LogTimer(LOGGER, "Reading audio"):
                data, sr = read_audio(path)
                return to_mono_int16(data), sr
        except Exception as e:
            raise _dead(path, "audio", e) from e

    video_data_1 = _read_video(video_file_1)
    video_data_2 = _read_video(video_file_2)
    # Reference quirks, kept (sample.py:445-459): file 2's sample rate
    # overwrites file 1's (corpora are one rate, 48 kHz), and frames are
    # indexed at an assumed 30 fps (sample_one_frame's default).
    audio_data_1, sampling_frequency = _read_audio(audio_file_1)
    audio_data_2, sampling_frequency = _read_audio(audio_file_2)

    def _generate():
        try:
            return generate_sample(
                audio_file_1, audio_data_1, audio_file_2, audio_data_2,
                video_file_1, video_data_1, video_file_2, video_data_2,
                sampling_frequency, augment=augment, include_metadata=include_metadata, rng=rng)
        except (ValueError, IndexError) as e:
            msg = (f"Could not sample from pair ({video_file_1}, "
                   f"{video_file_2}) - {type(e)}: {e}; Skipping...")
            LOGGER.warning(msg)
            warnings.warn(msg)
            raise StreamerDead(video_file_1) from e

    if precompute:
        # Draw enough samples up front that the clips can be freed
        # (reference sample.py:417-419: the Poisson 99.9 % quantile).
        import scipy.stats

        num_samples = int(scipy.stats.poisson.ppf(0.999, rate))
        samples = [_generate() for _ in range(num_samples)]
        del video_data_1, video_data_2, audio_data_1, audio_data_2
        while samples:
            yield samples.pop()
    else:
        while True:
            yield _generate()


class StreamMux:
    """k-way stochastic multiplexer over lazily-opened streamers — the
    pescador.Mux(k, rate).cycle() replacement.

    Each active streamer gets a Poisson(rate) sample budget; one sample
    is drawn per step from a uniformly-random active stream; exhausted
    or dead streams are replaced from the seed list (cycled)."""

    def __init__(self, seeds, k, rate, random_state=None, cycle=True):
        self.seeds = list(seeds)
        self.k = min(k, len(self.seeds))
        self.rate = rate
        self.cycle = cycle
        self.rng = np.random.RandomState(random_state)
        self._next_seed = 0
        self._active = []  # [generator, remaining budget]
        self.dead_streamers = 0
        for _ in range(self.k):
            self._activate_next()

    def _activate_next(self):
        # A factory only makes a generator; decode errors surface at its
        # first next() and are handled in __next__.
        if self._next_seed >= len(self.seeds):
            if not self.cycle:
                return False
            self._next_seed = 0
        factory = self.seeds[self._next_seed]
        self._next_seed += 1
        budget = max(1, int(self.rng.poisson(self.rate)))
        self._active.append([factory(), budget])
        return True

    def __iter__(self):
        return self

    def __next__(self):
        while self._active:
            idx = self.rng.randint(len(self._active))
            entry = self._active[idx]
            try:
                sample = next(entry[0])
            except StreamerDead:
                self.dead_streamers += 1
                LOGGER.warning("replacing dead streamer (%d failures so far)", self.dead_streamers)
                del self._active[idx]
                self._activate_next()
                continue
            except StopIteration:
                del self._active[idx]
                self._activate_next()
                continue
            entry[1] -= 1
            if entry[1] <= 0:
                del self._active[idx]
                self._activate_next()
            return sample
        raise StopIteration


def buffer_stream(stream, batch_size):
    """Group a sample stream into dict-of-arrays batches."""
    buf = []
    for sample in stream:
        buf.append(sample)
        if len(buf) == batch_size:
            yield {k: np.stack([s[k] for s in buf]) for k in buf[0]}
            buf = []


def data_generator(
    subset_path, k=32, batch_size=64, random_state=20171021,
    precompute=False, num_distractors=1, augment=False, rate=32,
    max_videos=None, include_metadata=False, cycle=True,
):
    """Batched AVC sample stream for a subset CSV (reference
    sample.py:508-562), from one ``random.Random(random_state)`` and the
    mux's ``RandomState(random_state)``."""
    rng = random.Random(random_state)

    file_list = read_csv_as_dicts(subset_path)
    if max_videos is not None and max_videos < len(file_list):
        LOGGER.info("Using a subset of %d videos", max_videos)
        rng.shuffle(file_list)
        file_list = file_list[:max_videos]

    if num_distractors >= 1 and len(file_list) < 2:
        raise ValueError(
            f"AVC sampling draws distractors from other videos; the subset "
            f"has {len(file_list)} video(s) (need >= 2)")

    seeds = []
    for video_1 in file_list:
        for _ in range(num_distractors):
            video_2 = video_1
            while video_2 == video_1:
                video_2 = rng.choice(file_list)

            def factory(v1=video_1, v2=video_2):
                return sampler(v1, v2, rate=rate, augment=augment, precompute=precompute,
                               include_metadata=include_metadata, rng=rng)

            seeds.append(factory)
    rng.shuffle(seeds)

    mux = StreamMux(seeds, k, rate, random_state=random_state, cycle=cycle)
    if batch_size == 1:
        return mux
    return buffer_stream(mux, batch_size)


def write_to_h5(path, batch, compression="gzip"):
    """One batch per HDF5 file (reference sample.py:565-568). compression:
    'gzip' (the reference's), 'lzf' (faster to decode) or None."""
    import h5py

    with h5py.File(path, "w") as f:
        for key in batch.keys():
            f.create_dataset(key, data=batch[key], compression=compression)


def sample_and_save(
    index, subset_path, num_batches, output_dir,
    num_streamers=32, batch_size=64, random_state=20171021,
    precompute=False, num_distractors=1, augment=False, rate=32,
    max_videos=None, include_metadata=False, compression="gzip",
):
    """Worker entry point: generate and write num_batches batches
    (reference sample.py:571-595), seeded random_state + index; file names
    {seed}_{worker}_{batch}.h5."""
    data_gen = data_generator(
        subset_path, batch_size=batch_size, random_state=random_state + index,
        k=num_streamers, augment=augment, num_distractors=num_distractors,
        max_videos=max_videos, precompute=precompute, rate=rate,
        include_metadata=include_metadata)
    os.makedirs(output_dir, exist_ok=True)
    for sub_index, batch in enumerate(data_gen):
        batch_path = os.path.join(output_dir, f"{random_state + index}_{index}_{sub_index}.h5")
        write_to_h5(batch_path, batch, compression=compression)
        if sub_index == (num_batches - 1):
            break
