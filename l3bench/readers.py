"""Arithmetic that several metric readers share. A reader takes the run's
record and returns its number, or None where the record holds nothing to
read it from (no trace, no step, no clip): the harness then leaves the
metric out of the result line."""

from __future__ import annotations

import re

from . import counts


def rate(rec: dict, key: str):
    """rec[key] (windows or pairs, all of the window's work) over the
    whole window's time."""
    if not rec.get(key) or not rec.get("window_s"):
        return None
    return rec[key] / rec["window_s"]


def op_share(rec: dict, pattern: str):
    """Share, in %, of the device's operation time in the traced stretch
    (on several cards, of their mean) that the operations whose names
    match `pattern` take."""
    trace = rec.get("trace")
    if not trace or not trace["ops"]:
        return None
    total = sum(trace["ops"].values())
    part = sum(v for k, v in trace["ops"].items() if re.search(pattern, k, re.I))
    return 100.0 * part / total if total > 0 else None


def idle(rec: dict):
    """Share, in %, of the traced stretch in which no operation ran on the
    device: 1 - (union of the device events' intervals) / (the stretch's
    length); on several cards, of the means over them."""
    trace = rec.get("trace")
    if not trace or trace["n_device_events"] == 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["stretch_s"])


def mfu(rec: dict, key: str, flops_each):
    """Model FLOP utilisation, in %: `flops_each(config)` for each of rec[key]
    (windows or pairs) of the whole window, over the window's time and the
    peak of the cell's precision (bf16 989 TFLOP/s; float32 with TF32 off
    67 TFLOP/s) times its cards."""
    if not rec.get(key):
        return None
    peak = counts.PEAK_FLOPS[rec["cell"]["precision"]] * rec["chips"]
    return 100.0 * rec[key] * flops_each(rec["config"]) / (rec["window_s"] * peak)
