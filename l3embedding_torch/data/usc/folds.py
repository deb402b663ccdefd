"""Fold assembly for downstream training (reference data/usc/folds.py; a
copy of ``l3embedding_tpu/data/usc/folds.py``, numpy only).

Per-file `.npz` features are concatenated per fold with `file_idxs`
spans retained for file-level evaluation; the split rule is: test fold =
given, valid fold = (test - 1) % n, train = the rest."""

from __future__ import annotations

import os

import numpy as np

NUM_FOLDS_US8K = 10
NUM_FOLDS_ESC50 = 5
NUM_FOLDS_DCASE2013 = 2

DATASET_NUM_FOLDS = {
    "us8k": NUM_FOLDS_US8K,
    "esc50": NUM_FOLDS_ESC50,
    "dcase2013": NUM_FOLDS_DCASE2013,
}


def load_feature_file(path):
    data = np.load(path)
    X, y = data["X"], data["y"]
    if isinstance(y, np.ndarray) and y.ndim == 0:
        y = int(y)
    return X, y


def get_fold(feature_dir, fold_idx, augment=False, dataset_name=None):
    """Load all .npz files of fold `fold_idx` (0-based)
    (reference folds.py:24-61). US8K augmented variants (filenames with
    extra '_' suffixes) are skipped unless augment=True
    (reference folds.py:35-36). The reference keys that skip on the
    substring 'us8k' appearing in the PATH; `dataset_name` (forwarded by
    get_split) makes it robust to feature directories that don't carry
    the dataset name — the path heuristic is kept as a fallback for
    direct get_fold callers."""
    X, y, file_idxs = [], [], []
    fold_dir = os.path.join(feature_dir, f"fold{fold_idx + 1}")
    filenames = sorted(os.listdir(fold_dir))

    start = 0
    used_filenames = []
    for fname in filenames:
        # US8K augmented-variant skip: base stems are
        # '<fsID>-<classID>-<occurrence>-<slice>'; augmented variants
        # append '_<aug>' (reference folds.py:35-36).
        is_us8k = (dataset_name == "us8k" if dataset_name is not None
                   else "us8k" in fold_dir)
        if is_us8k and "_" in fname and not augment:
            continue
        file_X, file_y = load_feature_file(os.path.join(fold_dir, fname))
        end = start + (file_X.shape[0] if file_X.ndim > 1 else 1)
        X.append(file_X)
        y.append(file_y)
        file_idxs.append([start, end])
        start = end
        used_filenames.append(fname)

    X = np.vstack(X)
    if isinstance(y[0], int) or np.ndim(y[0]) == 0:
        y = np.array(y)
    else:
        y = np.concatenate(y)
    return {
        "features": X,
        "labels": y,
        "file_idxs": np.array(file_idxs),
        "filenames": used_filenames,
    }


def get_valid_fold_idx(test_fold_idx, num_folds):
    return (test_fold_idx - 1) % num_folds


def get_train_folds(feature_dir, test_fold_idx, num_folds, valid=True,
                    dataset_name=None):
    """All folds except test (and valid), concatenated with global
    file_idxs (reference folds.py:82-112)."""
    X, y, file_idxs, filenames = [], [], [], []
    valid_fold_idx = get_valid_fold_idx(test_fold_idx, num_folds)
    for fold_idx in range(num_folds):
        if fold_idx == test_fold_idx or (valid and fold_idx == valid_fold_idx):
            continue
        fold = get_fold(feature_dir, fold_idx, augment=True,
                        dataset_name=dataset_name)
        idxs = fold["file_idxs"]
        if file_idxs:
            idxs = idxs + file_idxs[-1][-1, -1]
        X.append(fold["features"])
        y.append(fold["labels"])
        file_idxs.append(idxs)
        filenames += fold["filenames"]
    return {
        "features": np.vstack(X),
        "labels": np.concatenate(y),
        "file_idxs": np.vstack(file_idxs),
        "filenames": filenames,
    }


def get_split(feature_dir, test_fold_idx, dataset_name, valid=True):
    """(train, valid, test) fold data dicts (reference folds.py:64-79)."""
    if dataset_name not in DATASET_NUM_FOLDS:
        raise ValueError(f"Invalid dataset: {dataset_name}")
    num_folds = DATASET_NUM_FOLDS[dataset_name]
    train_data = get_train_folds(feature_dir, test_fold_idx, num_folds,
                                 valid=valid, dataset_name=dataset_name)
    valid_data = (
        get_fold(feature_dir, get_valid_fold_idx(test_fold_idx, num_folds),
                 dataset_name=dataset_name)
        if valid
        else None
    )
    test_data = get_fold(feature_dir, test_fold_idx, dataset_name=dataset_name)
    return train_data, valid_data, test_data
