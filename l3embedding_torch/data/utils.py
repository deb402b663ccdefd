"""Small host-side data utilities (a copy of ``l3embedding_tpu/data/utils.py``;
reference data/utils.py:5-32)."""

from __future__ import annotations

import csv
import multiprocessing


def read_csv_as_dicts(path):
    with open(path, "r") as f:
        return list(csv.DictReader(f))


def map_iterate_in_parallel(iterable, function, processes=8):
    """mp.Pool map wrapper. With processes<=1, maps inline (useful on
    single-core hosts and under test). The workers are spawned, not forked
    (the JAX package forks): a forked child of a process with threads, or
    with CUDA initialised, may find them in a broken state. `function`
    must be importable by path, and the caller's entry point guarded by
    ``if __name__ == "__main__"``."""
    if processes <= 1:
        return [function(x) for x in iterable]
    with multiprocessing.get_context("spawn").Pool(processes=processes) as pool:
        return list(pool.map(function, iterable))


def flatten_dict(dct, parent_key=None):
    out = type(dct)()
    for k, v in dct.items():
        key = f"{parent_key}_{k}" if parent_key is not None else k
        if isinstance(v, dict):
            out.update(flatten_dict(v, parent_key=key))
        else:
            out[key] = v
    return out
