"""Classification metrics (a copy of ``l3embedding_tpu/classifier/metrics.py``,
numpy only; reference classifier/metrics.py:8-115)."""

from __future__ import annotations

import logging

import numpy as np

LOGGER = logging.getLogger("l3embedding_torch.classifier-metrics")


def compute_metrics(y, pred, num_classes=10):
    """Accuracy + per-class + average class accuracy; accepts one-hot or
    integer labels (reference metrics.py:8-46)."""
    y = np.array(y)
    pred = np.array(pred)
    if y.ndim == 2:
        y = np.argmax(y, axis=1)
    if pred.ndim == 2:
        pred = np.argmax(pred, axis=1)

    acc = (y == pred).mean()
    class_acc = []
    for class_idx in range(num_classes):
        idxs = y == class_idx
        class_acc.append((y[idxs] == pred[idxs]).mean() if idxs.any() else np.nan)
    return {
        "accuracy": acc,
        "class_accuracy": class_acc,
        "average_class_accuracy": np.nanmean(class_acc),
    }


def aggregate_metrics(fold_metrics):
    """Cross-fold stats (reference metrics.py:49-78)."""
    keys = list(fold_metrics[0].keys())
    lists = {k: [fold[k] for fold in fold_metrics] for k in keys}
    return {
        k: {
            "mean": np.mean(v),
            "var": np.var(v),
            "min": np.min(v),
            "25_%ile": np.percentile(v, 25),
            "75_%ile": np.percentile(v, 75),
            "median": np.median(v),
            "max": np.max(v),
        }
        for k, v in lists.items()
    }


def collapse_metrics(metrics_list):
    keys = list(metrics_list[0].keys())
    return {k: [step[k] for step in metrics_list] for k in keys}


def print_metrics(metrics, subset_name):
    LOGGER.info("Results metrics for %s", subset_name)
    LOGGER.info("=====================================================")
    for metric, stats in metrics.items():
        LOGGER.info("* %s", metric)
        for name, val in stats.items():
            LOGGER.info("\t- %s: %s", name, val)
