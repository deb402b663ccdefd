"""Downstream feature computation and preprocessing (port of
``l3embedding_tpu/data/usc/features.py``, reference data/usc/features.py).

``compute_file_features`` computes 'l3' features with the port's
extractors (``EmbeddingExtractor`` or ``QuantizedEmbeddingExtractor``) and
'vggish' features with the resident ``models.vggish.VGGishExtractor``. The
numpy / scipy helpers are copies. The preprocessing that fits sklearn
scalers (``preprocess_split_data``) imports sklearn inside the function, so
that the extraction stage (``05``) starts on a machine without it.
"""

from __future__ import annotations

import logging

import numpy as np
import scipy.stats

from ..audio_io import load_audio

LOGGER = logging.getLogger("l3embedding_torch.cls-data")


def one_hot(idx, n_classes=10):
    y = np.zeros((n_classes,))
    y[idx] = 1
    return y


def sample_non_overlap_file(X, chunk_size=10):
    """First frame of every chunk_size-frame chunk
    (reference features.py:52-57)."""
    return np.array([X[i] for i in range(0, len(X), chunk_size)])


def remove_data_overlap(data, chunk_size=10):
    """Decimate overlapping frames per file, in place
    (reference features.py:60-74)."""
    X, file_idxs = [], []
    new_start = 0
    for start, end in data["file_idxs"]:
        feats = sample_non_overlap_file(data["features"][start:end], chunk_size)
        X.append(feats)
        file_idxs.append([new_start, new_start + feats.shape[0]])
        new_start += feats.shape[0]
    data["features"] = np.vstack(X)
    data["file_idxs"] = np.array(file_idxs)


def compute_stats_features(embeddings):
    """7 summary stats over the frame axis (reference features.py:243-253)."""
    return np.concatenate(
        (
            np.min(embeddings, axis=0),
            np.max(embeddings, axis=0),
            np.median(embeddings, axis=0),
            np.mean(embeddings, axis=0),
            np.var(embeddings, axis=0),
            scipy.stats.skew(embeddings, axis=0),
            scipy.stats.kurtosis(embeddings, axis=0),
        )
    )


def framewise_to_stats(data):
    X = [
        compute_stats_features(data["features"][start:end])
        for start, end in data["file_idxs"]
    ]
    data["features"] = np.vstack(X)
    idxs = np.arange(data["features"].shape[0])
    data["file_idxs"] = np.column_stack((idxs, idxs + 1))


def expand_framewise_labels(data):
    labels = [
        np.tile(y, end - start)
        for y, (start, end) in zip(data["labels"], data["file_idxs"])
    ]
    data["labels"] = np.concatenate(labels)


def preprocess_split_data(
    train_data,
    valid_data,
    test_data,
    feature_mode="framewise",
    non_overlap=False,
    non_overlap_chunk_size=10,
    use_min_max=False,
):
    """Mutating preprocessing pipeline (reference features.py:98-163):
    overlap removal → optional MinMax → framewise/stats mode → Standard
    scaling → train shuffle. Returns the fitted scalers for persistence.
    """
    from sklearn.preprocessing import MinMaxScaler, StandardScaler

    if non_overlap:
        remove_data_overlap(train_data, chunk_size=non_overlap_chunk_size)
        if valid_data:
            remove_data_overlap(valid_data, chunk_size=non_overlap_chunk_size)
        remove_data_overlap(test_data, chunk_size=non_overlap_chunk_size)

    min_max_scaler = MinMaxScaler()
    if use_min_max:
        train_data["features"] = min_max_scaler.fit_transform(train_data["features"])
        if valid_data:
            valid_data["features"] = min_max_scaler.transform(valid_data["features"])
        test_data["features"] = min_max_scaler.transform(test_data["features"])

    if feature_mode == "framewise":
        expand_framewise_labels(train_data)
        if valid_data:
            expand_framewise_labels(valid_data)
    elif feature_mode == "stats":
        framewise_to_stats(train_data)
        if valid_data:
            framewise_to_stats(valid_data)
        framewise_to_stats(test_data)
    else:
        raise ValueError(f"Invalid feature mode: {feature_mode}")

    stdizer = StandardScaler()
    train_data["features"] = stdizer.fit_transform(train_data["features"])
    if valid_data:
        valid_data["features"] = stdizer.transform(valid_data["features"])
    test_data["features"] = stdizer.transform(test_data["features"])

    num_train = len(train_data["labels"])
    shuffle_idxs = np.random.permutation(num_train)
    reverse = np.argsort(shuffle_idxs)
    train_data["features"] = train_data["features"][shuffle_idxs]
    train_data["labels"] = train_data["labels"][shuffle_idxs]
    train_data["file_idxs"] = [
        reverse[slice(*pair)] for pair in train_data["file_idxs"]
    ]
    return min_max_scaler, stdizer


def preprocess_features(data, min_max_scaler, stdizer, feature_mode="framewise"):
    """Apply previously-fitted scalers + feature mode to new data.

    Fixed vs the reference (features.py:152-163), which called
    min_max_scaler.fit_transform here — REFITTING the "previously-
    fitted" scaler on the new data's own min/max (and silently applying
    min-max even when training skipped it), then standardizing inputs
    whose distribution no longer matches what stdizer was fitted on.
    (Dead code there; a real API here, so it does what it says.)"""
    # preprocess_split_data returns an UNFITTED MinMaxScaler when
    # use_min_max=False — only apply a scaler that was actually fitted.
    if min_max_scaler is not None and hasattr(min_max_scaler, "data_min_"):
        data["features"] = min_max_scaler.transform(data["features"])
    if feature_mode == "framewise":
        expand_framewise_labels(data)
    elif feature_mode == "stats":
        framewise_to_stats(data)
    else:
        raise ValueError(f"Invalid feature mode: {feature_mode}")
    data["features"] = stdizer.transform(data["features"])


def flatten_file_frames(X, y):
    """Flatten per-file frame features and repeat labels per frame
    (reference features.py:329-365)."""
    if X.ndim == 1:
        num_frames_per_file = []
        X_flat = []
        for X_file in X:
            num_frames_per_file.append(len(X_file))
            X_flat += list(X_file)
        X_flat = np.array(X_flat)
    else:
        num_files, num_frames_per_file = X.shape[0], X.shape[1]
        X_flat = X.reshape((num_files * num_frames_per_file,) + X.shape[2:])
    y_flat = np.repeat(y, num_frames_per_file)
    return X_flat, y_flat


def get_l3_frames_uniform(audio, extractor, hop_size=0.1, sr=48000, defer=False):
    """L3 embedding per overlapping 1 s window (reference
    features.py:256-306); `extractor` is one of the port's extractors.
    defer=True returns its asynchronous handle (an ``EmbeddingRows``:
    ``result()`` gives the rows), so a file loop can overlap this file's
    device work with the previous file's npz write."""
    if isinstance(audio, str):
        audio = load_audio(audio, sr)
    if defer:
        return extractor.embed_audio_async(audio, hop_size=hop_size)
    return extractor.embed_audio(audio, hop_size=hop_size)


def get_vggish_frames_uniform(audio_path, hop_size=0.1, resources_dir=None, device="cuda",
                              extractor=None):
    """VGGish embedding frames (reference features.py:166-238) from one
    resident model (`extractor`, else the cached one of `resources_dir` on
    `device`), not a fresh graph per file."""
    from ...models.vggish import VGGishExtractor

    extractor = extractor or VGGishExtractor.get_cached(resources_dir, device)
    return extractor.embed_file(audio_path, hop_size=hop_size)


def check_feature_type(feature_type: str) -> None:
    """Raise for a feature type that is neither 'l3' nor 'vggish'."""
    if feature_type not in ("l3", "vggish"):
        raise ValueError(f"Invalid feature type: {feature_type}")


def compute_file_features(path, feature_type, l3embedding_model=None, defer=False, **feature_args):
    """Dispatch (reference features.py:309-323). `l3embedding_model` is an
    extractor (name kept for CLI-surface parity; for 'vggish' a
    ``VGGishExtractor``, or None for the cached one of
    ``feature_args["resources_dir"]``). defer=True returns an L3
    extractor's asynchronous handle instead of an ndarray; VGGish rows are
    returned as an ndarray."""
    check_feature_type(feature_type)
    hop_size = feature_args.get("hop_size", 0.1)
    if feature_type == "vggish":
        return get_vggish_frames_uniform(
            path, hop_size=hop_size, resources_dir=feature_args.get("resources_dir"),
            device=feature_args.get("device", "cuda"), extractor=l3embedding_model,
        )
    if not l3embedding_model:
        raise ValueError(f"Must provide L3 embedding model to use {feature_type} features")
    return get_l3_frames_uniform(path, l3embedding_model, hop_size=hop_size, defer=defer)
