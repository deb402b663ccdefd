"""Per-dataset downstream feature generation: UrbanSound8K, ESC-50,
DCASE2013 SCD (port of ``l3embedding_tpu/data/usc/datasets.py``; reference
data/usc/us8k.py, esc50.py, dcase2013.py).

All three follow the same shape — iterate the fold's audio files, compute
windowed embeddings, write one compressed `.npz` per file (X=frame
embeddings, y=class), skipping existing outputs for idempotency. The
label conventions differ per dataset:
  us8k:      classID from the metadata CSV (glob-matched augmented
             variants included)            (reference us8k.py:17-164)
  esc50:     trailing '-<class>' in stem   (reference esc50.py:71)
  dcase2013: stem prefix → CLASS_TO_INT    (reference dcase2013.py:15-28)
"""

from __future__ import annotations

import csv
import glob
import logging
import os
import random

import numpy as np

from ...utils.log import LogTimer
from .features import compute_file_features

LOGGER = logging.getLogger("l3embedding_torch.cls-data")

# Single source of truth for fold counts lives in .folds (get_split
# derives DATASET_NUM_FOLDS from the same values).
from .folds import (  # noqa: E402
    NUM_FOLDS_DCASE2013,
    NUM_FOLDS_ESC50,
    NUM_FOLDS_US8K,
)

DCASE2013_CLASS_TO_INT = {
    "bus": 0, "busystreet": 1, "office": 2, "openairmarket": 3, "park": 4,
    "quietstreet": 5, "restaurant": 6, "supermarket": 7, "tube": 8,
    "tubestation": 9,
}


def load_us8k_metadata(path):
    """UrbanSound8K.csv → list of 10 per-fold {fname: row} dicts
    (reference us8k.py:17-39)."""
    metadata = [{} for _ in range(NUM_FOLDS_US8K)]
    with open(path) as f:
        for row in csv.DictReader(f):
            row["start"] = float(row["start"])
            row["end"] = float(row["end"])
            row["salience"] = float(row["salience"])
            row["fold"] = int(row["fold"])
            row["classID"] = int(row["classID"])
            metadata[row["fold"] - 1][row["slice_file_name"]] = row
    return metadata


def _write_features(audio_path, output_path, features, l3embedding_model,
                    defer=False, **feature_args):
    if os.path.exists(output_path):
        LOGGER.info("File %s already exists", output_path)
        return None
    X = compute_file_features(
        audio_path, features, l3embedding_model=l3embedding_model,
        defer=defer, **feature_args
    )
    if X is None:
        LOGGER.error("Could not generate data for %s", audio_path)
        return None
    return X


class _PendingWriter:
    """Write-behind npz writer for the per-file extraction loops.

    The per-file chain — decode → device dispatch → sync → gzip'd
    np.savez_compressed — is otherwise fully serial, so the device
    idles during every file's compression and the host idles during
    every file's compute. Holding up to `depth` dispatched files
    pending (their X is an extractor's asynchronous handle from
    compute_file_features(defer=True), whose ``result()`` gives the rows)
    overlaps file k's materialize+compress with file k+1's decode+compute.
    Files are written in dispatch order; identical bytes to the serial
    loop."""

    def __init__(self, depth: int = 2):
        from collections import deque

        self.depth = max(1, int(depth))
        self._pending = deque()

    def add(self, output_path, X, y):
        self._pending.append((output_path, X, y))
        while len(self._pending) >= self.depth:
            self._flush_one()

    def _flush_one(self):
        output_path, X, y = self._pending.popleft()
        np.savez_compressed(output_path, X=X.result() if hasattr(X, "result") else X, y=y)

    def close(self):
        while self._pending:
            self._flush_one()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        # On error, still land what was already dispatched (idempotent
        # reruns then skip those files).
        self.close()
        return False


# ---------------------------------------------------------------- us8k

def generate_us8k_file_data(fname, example_metadata, audio_fold_dir,
                            output_fold_dir, features, l3embedding_model,
                            writer=None, **feature_args):
    audio_path = os.path.join(audio_fold_dir, fname)
    basename = os.path.splitext(fname)[0]
    output_path = os.path.join(output_fold_dir, basename + ".npz")
    X = _write_features(audio_path, output_path, features, l3embedding_model,
                        defer=writer is not None, **feature_args)
    if X is None:
        return
    if writer is not None:
        writer.add(output_path, X, example_metadata["classID"])
    else:
        np.savez_compressed(output_path, X=X, y=example_metadata["classID"])
    return output_path, "success"


def generate_us8k_fold_data(metadata, data_dir, fold_idx, output_dir,
                            l3embedding_model=None, features="l3",
                            random_state=12345678, **feature_args):
    if isinstance(metadata, str):
        metadata = load_us8k_metadata(metadata)
    random_state = random_state + fold_idx
    random.seed(random_state)
    np.random.seed(random_state)

    audio_fold_dir = os.path.join(data_dir, f"fold{fold_idx + 1}")
    output_fold_dir = os.path.join(output_dir, f"fold{fold_idx + 1}")
    os.makedirs(output_fold_dir, exist_ok=True)
    LOGGER.info("Generating fold %d in %s", fold_idx + 1, output_fold_dir)

    num_files = len(metadata[fold_idx])
    with _PendingWriter() as writer:
        for idx, (fname, example_metadata) in enumerate(
                metadata[fold_idx].items()):
            with LogTimer(LOGGER,
                          f"({idx+1}/{num_files}) Processed {fname} -"):
                # Glob-match augmented variants of the base clip
                # (reference us8k.py:127-130).
                stem = os.path.splitext(fname)[0]
                variants = [
                    x
                    for x in glob.glob(
                        os.path.join(
                            audio_fold_dir, "**", stem + "[!0-9]*[wm][ap][v3]"
                        ),
                        recursive=True,
                    )
                    if os.path.isfile(x) and not x.endswith(".jams")
                ]
                for var_path in variants:
                    generate_us8k_file_data(
                        os.path.basename(var_path),
                        example_metadata,
                        os.path.dirname(var_path),
                        output_fold_dir,
                        features,
                        l3embedding_model,
                        writer=writer,
                        **feature_args,
                    )


def generate_us8k_folds(metadata_path, data_dir, output_dir,
                        l3embedding_model=None, features="l3",
                        random_state=12345678, **feature_args):
    metadata = load_us8k_metadata(metadata_path)
    for fold_idx in range(NUM_FOLDS_US8K):
        generate_us8k_fold_data(
            metadata, data_dir, fold_idx, output_dir,
            l3embedding_model=l3embedding_model, features=features,
            random_state=random_state, **feature_args,
        )


# --------------------------------------------------------------- esc50

def generate_esc50_file_data(fname, audio_fold_dir, output_fold_dir, features,
                             l3embedding_model, writer=None, **feature_args):
    audio_path = os.path.join(audio_fold_dir, fname)
    basename = os.path.splitext(fname)[0]
    output_path = os.path.join(output_fold_dir, basename + ".npz")
    X = _write_features(audio_path, output_path, features, l3embedding_model,
                        defer=writer is not None, **feature_args)
    if X is None:
        return
    y = int(basename.split("-")[-1])
    if writer is not None:
        writer.add(output_path, X, y)
    else:
        np.savez_compressed(output_path, X=X, y=y)
    return output_path, "success"


def generate_esc50_fold_data(data_dir, fold_idx, output_dir,
                             l3embedding_model=None, features="l3",
                             random_state=12345678, **feature_args):
    random_state = random_state + fold_idx
    random.seed(random_state)
    np.random.seed(random_state)
    audio_fold_dir = os.path.join(data_dir, f"fold{fold_idx + 1}")
    output_fold_dir = os.path.join(output_dir, f"fold{fold_idx + 1}")
    os.makedirs(output_fold_dir, exist_ok=True)
    files = sorted(glob.glob(audio_fold_dir + "/*"))
    with _PendingWriter() as writer:
        for idx, f in enumerate(files):
            fname = os.path.basename(f)
            with LogTimer(LOGGER,
                          f"({idx+1}/{len(files)}) Processed {fname} -"):
                generate_esc50_file_data(
                    fname, audio_fold_dir, output_fold_dir, features,
                    l3embedding_model, writer=writer, **feature_args,
                )


def generate_esc50_folds(data_dir, output_dir, l3embedding_model=None,
                         features="l3", random_state=12345678, **feature_args):
    for fold_idx in range(NUM_FOLDS_ESC50):
        generate_esc50_fold_data(
            data_dir, fold_idx, output_dir,
            l3embedding_model=l3embedding_model, features=features,
            random_state=random_state, **feature_args,
        )


# ----------------------------------------------------------- dcase2013

def generate_dcase2013_file_data(fname, audio_fold_dir, output_fold_dir,
                                 features, l3embedding_model, writer=None,
                                 **feature_args):
    audio_path = os.path.join(audio_fold_dir, fname)
    basename = os.path.splitext(fname)[0]
    output_path = os.path.join(output_fold_dir, basename + ".npz")
    X = _write_features(audio_path, output_path, features, l3embedding_model,
                        defer=writer is not None, **feature_args)
    if X is None:
        return
    # Stem is '<class><2-digit index>' (reference dcase2013.py:85).
    y = DCASE2013_CLASS_TO_INT[basename[:-2]]
    if writer is not None:
        writer.add(output_path, X, y)
    else:
        np.savez_compressed(output_path, X=X, y=y)
    return output_path, "success"


def generate_dcase2013_fold_data(data_dir, fold_idx, output_dir,
                                 l3embedding_model=None, features="l3",
                                 random_state=12345678, **feature_args):
    random_state = random_state + fold_idx
    random.seed(random_state)
    np.random.seed(random_state)
    audio_fold_dir = os.path.join(data_dir, f"fold{fold_idx + 1}")
    output_fold_dir = os.path.join(output_dir, f"fold{fold_idx + 1}")
    os.makedirs(output_fold_dir, exist_ok=True)
    files = sorted(glob.glob(audio_fold_dir + "/*"))
    with _PendingWriter() as writer:
        for idx, f in enumerate(files):
            fname = os.path.basename(f)
            with LogTimer(LOGGER,
                          f"({idx+1}/{len(files)}) Processed {fname} -"):
                generate_dcase2013_file_data(
                    fname, audio_fold_dir, output_fold_dir, features,
                    l3embedding_model, writer=writer, **feature_args,
                )


def generate_dcase2013_folds(data_dir, output_dir, l3embedding_model=None,
                             features="l3", random_state=12345678,
                             **feature_args):
    for fold_idx in range(NUM_FOLDS_DCASE2013):
        generate_dcase2013_fold_data(
            data_dir, fold_idx, output_dir,
            l3embedding_model=l3embedding_model, features=features,
            random_state=random_state, **feature_args,
        )
