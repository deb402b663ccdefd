"""Batch repair: re-read the source audio at each row's recorded
``audio_start_sample_idx`` and rewrite the ``audio`` and ``audio_gain``
datasets of existing HDF5 batches in place, with a fresh gain draw (port of
the root ``recompute_batch_audio.py``; reference
recompute_batch_audio.py:17-131). The same flags and behaviour:

    python -m l3embedding_torch.tools.recompute_batch_audio BATCH_DIR SUBSET_CSV \\
        [--n-jobs N] [--verbose K]

Needs batches written with ``--include-metadata``, and h5py: it runs on the
host. The gains come from the global ``random`` module, as the root tool's;
``--n-jobs`` workers are spawned.
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import random
import sys
import traceback

import numpy as np

from ..data.audio_io import read_audio, to_mono_int16
from ..data.sample import augment_gain, pad_to_one_second
from ..data.utils import read_csv_as_dicts


def sample_one_second(audio_data, sampling_frequency, start, augment=False):
    """The 1 s slice at `start` (zero-padded when short) with a fresh gain
    draw (reference recompute_batch_audio.py:17-57) → (audio, aug_params)."""
    sampling_frequency = int(sampling_frequency)
    audio_data = pad_to_one_second(audio_data[start : start + sampling_frequency], sampling_frequency)
    if augment:
        audio_data, gain = augment_gain(audio_data, random)
        return audio_data, {"gain": gain}
    return audio_data, {}


def print_flush(*args, **kwargs):
    print(*args, **kwargs)
    sys.stdout.flush()


def process_batch(*args):
    """(batch_path, fname_to_path), or one tuple of them (for imap)."""
    if len(args) == 2:
        batch_path, fname_to_path = args
    elif len(args) == 1:
        batch_path, fname_to_path = args[0]
    else:
        raise ValueError("Invalid number of arguments")
    import h5py

    try:
        with h5py.File(batch_path, "r+") as blob:
            audio_files = [x.decode("utf8") for x in blob["audio_file"]]
            starts = [int(x) for x in blob["audio_start_sample_idx"]]
            audio, audio_gain = [], []
            for fname, start_idx in zip(audio_files, starts):
                audio_path = fname_to_path[fname]
                data, _ = read_audio(audio_path)
                data, aug = sample_one_second(to_mono_int16(data), 48000, start_idx, augment=True)
                gain = aug["gain"]
                if not (0.9 <= gain <= 1.1):
                    raise ValueError(
                        f"File {audio_path} in batch {batch_path} has invalid audio gain {gain}")
                audio.append(data)
                audio_gain.append(gain)
            blob["audio"][:, :, :] = np.ascontiguousarray(np.vstack(audio)[:, None, :])
            blob["audio_gain"][:] = np.array(audio_gain)
    except Exception:
        print_flush(traceback.format_exc())
        raise


def process_subset(subset_batch_dir, subset_path, n_jobs=1, verbose=0):
    fname_to_path = {
        os.path.basename(x["audio_filepath"]): x["audio_filepath"]
        for x in read_csv_as_dicts(subset_path)
    }
    file_list = os.listdir(subset_batch_dir)
    num_files = len(file_list)
    if n_jobs > 1:
        worker_args = ((os.path.join(subset_batch_dir, fname), fname_to_path) for fname in file_list)
        with multiprocessing.get_context("spawn").Pool(n_jobs) as pool:
            for idx, _ in enumerate(pool.imap_unordered(process_batch, worker_args)):
                if verbose > 0 and (idx + 1) % verbose == 0:
                    print_flush(f"Processed {idx + 1}/{num_files}")
    else:
        for idx, fname in enumerate(file_list):
            process_batch(os.path.join(subset_batch_dir, fname), fname_to_path)
            if verbose > 0 and (idx + 1) % verbose == 0:
                print_flush(f"Processed {idx + 1}/{num_files}")


def main(argv=None):
    parser = argparse.ArgumentParser(description="Recompute batch audio")
    parser.add_argument("batch_dir", type=str, help="Directory where batch files are")
    parser.add_argument("subset_path", type=str, help="Path to subset csv file")
    parser.add_argument("--n-jobs", type=int, default=1, help="Number of parallel jobs to run")
    parser.add_argument("--verbose", type=int, default=0, help="Verbosity level")
    args = parser.parse_args(argv)
    process_subset(args.batch_dir, args.subset_path, n_jobs=args.n_jobs, verbose=args.verbose)


if __name__ == "__main__":
    main()
