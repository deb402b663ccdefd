"""Experiment tracking (a copy of ``l3embedding_tpu/utils/tracker.py``).

The reference upserts experiment rows into a shared Google Sheet
(reference gsheets.py:112-190, train.py:55-105). The tracker here is a
pluggable interface with a local JSONL backend as the default — the same
row schema, no network dependency. A Google-Sheets backend can be
registered by name when credentials machinery is available; the training
loop only talks to the interface.
"""

from __future__ import annotations

import json
import math
import os
import threading
from typing import Any

import numpy as np

# Column schemas mirroring reference gsheets.py:11-73.
EMBEDDING_FIELD_NAMES = [
    "username", "model_dir", "model_type", "train_data_dir",
    "validation_data_dir", "num_epochs", "train_epoch_size",
    "validation_epoch_size", "train_batch_size", "validation_batch_size",
    "random_state", "learning_rate", "git_commit",
    "latest_epoch", "latest_train_loss", "latest_validation_loss",
    "latest_train_acc", "latest_validation_acc",
    "best_train_loss", "best_validation_loss",
    "best_train_acc", "best_validation_acc",
]

CLASSIFIER_FIELD_NAMES = [
    "username", "model_dir", "git_commit", "features_dir", "model_type",
    "feature_mode", "train_num_streamers", "train_batch_size",
    "random_state", "learning_rate", "weight_decay", "C", "tol",
    "max_iterations", "test_acc", "test_avg_class_acc", "test_class_acc",
    "valid_acc", "valid_avg_class_acc", "train_acc",
]


class ExperimentTracker:
    """Interface: upsert a row keyed by model_dir, update metric columns."""

    def upsert(self, row: dict) -> None:
        raise NotImplementedError

    def update(self, model_dir: str, values: dict) -> None:
        raise NotImplementedError


def _sanitize(obj):
    """Replace non-finite floats with None so emitted JSON is strict.

    A zero-train-step resumed epoch legitimately reports NaN train
    metrics (training/loop.py); json.dump would emit the non-standard
    bare `NaN` token, which strict JSON parsers reject. Null is the
    faithful strict-JSON encoding of "metric unavailable".
    """
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, np.floating):
        # np.float32/np.float16 scalars are NOT `float` subclasses (only
        # np.float64 is); without this branch a NaN np.float32 bypasses
        # the finite check and default=str serializes it as the STRING
        # "nan" — type-inconsistent with the null other rows carry.
        f = float(obj)
        return f if math.isfinite(f) else None
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.bool_):
        return bool(obj)
    if isinstance(obj, np.ndarray) and obj.ndim == 0:
        # 0-d arrays (e.g. an un-itemized device_get result) would fall
        # through to default=str just like the scalar cases above.
        return _sanitize(obj.item())
    if isinstance(obj, dict):
        return {k: _sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_sanitize(v) for v in obj]
    return obj


class JSONLTracker(ExperimentTracker):
    """Append-only JSONL event log + latest-state sidecar.

    Every upsert/update appends an event; `state_path` holds the merged
    latest row per model_dir for cheap reading by reporting tools.
    Non-finite floats are serialized as null (strict JSON).
    """

    def __init__(self, path: str):
        self.path = path
        self.state_path = path + ".state.json"
        self._lock = threading.Lock()

    def _append(self, event: dict) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        with self._lock, open(self.path, "a") as f:
            f.write(
                json.dumps(_sanitize(event), default=str, allow_nan=False)
                + "\n"
            )

    def _merge_state(self, key: str, values: dict) -> None:
        state: dict[str, Any] = {}
        if os.path.exists(self.state_path):
            with open(self.state_path) as f:
                # Sanitize the LOADED state too: files written before
                # strict-JSON mode can carry bare NaN tokens (json.load
                # accepts them), and re-dumping them with allow_nan=False
                # would raise — taking down the training run on resume.
                state = _sanitize(json.load(f))
        row = state.get(key, {})
        row.update(_sanitize(values))
        state[key] = row
        tmp = self.state_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f, indent=2, default=str, allow_nan=False)
        os.replace(tmp, self.state_path)

    def upsert(self, row: dict) -> None:
        key = str(row.get("model_dir", ""))
        self._append({"event": "upsert", "row": row})
        with self._lock:
            self._merge_state(key, row)

    def update(self, model_dir: str, values: dict) -> None:
        self._append({"event": "update", "model_dir": model_dir, "values": values})
        with self._lock:
            self._merge_state(model_dir, values)


class NullTracker(ExperimentTracker):
    def upsert(self, row: dict) -> None:
        pass

    def update(self, model_dir: str, values: dict) -> None:
        pass

