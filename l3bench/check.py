"""The comparisons that decide ``correct``.

Every number compared is a gap between what the program produced on its
timed path and what the plain reference gives for the same inputs; each is
held below a limit of its own, written in the cell's file, which names the
numbers it compares. The others are reported beside them.

Extraction (answers checked one by one), over a seeded sample of the
window's clips:
  * ``bad_counts``: clips whose rows the program returned in another
    number than the reference's framing gives (limit 0);
  * ``clip_err``: the worst clip's median row error ``|p - r| / |r|``, so
    that one clip going wrong fails, while a lone row over a near-zero STFT
    bin, or bf16's widest row, does not;
  * ``clip_p90``: the worst clip's 90th-percentile row error, and
    ``clip_mean``, the worst clip's mean row error: a fault that alters a
    tenth or more of a clip's rows (its tail windows, say) moves the first,
    and a large error in fewer rows the second, where the median stays;
  * ``row_err`` (reported): the widest row's error.
A clip of the window that never returned, or returned a row that is not
finite, counts as failed (the driver's ``failed``), sampled or not.

Training (the first three steps, which set-up drives through the window's
own call and feed). A leaf's gap is ``| |p| - |r| |``, its deviation
``|p - r|``, each over the larger of ``|r|`` and the median leaf's ``|r|``.
  * ``emb_err``: over the global batch of the first step, the largest
    ``|p - r| / |r|`` of a tower's output row (both towers, train-mode
    BatchNorm, the front end; on several cards every rank's rows);
  * ``grad_gap``: the median leaf's gap of the first step's gradient as the
    optimizer got it (from Adam's first moment after the step): a loss over
    other rows than the batch's, or over half of them, moves it, where the
    towers' rows and so ``emb_err`` stay;
  * ``change_gap``: the worst leaf's gap of each leaf's change over the
    three steps (parameters and running statistics), leaving out the leaves
    whose reference gradient is under a thousandth of the median leaf's
    (conv biases that feed a BatchNorm: Adam moves them by round-off alone).
    A leaf left unmoved, or moved twice, reads 1.
Reported beside them: each step's loss gap, the towers' median row, the
gradient's and the change's deviations and worst leaves. A gap of norms is
of the second order in rounding noise that is uncorrelated with the leaf,
and a leaf's deviation swings with the max-pools' and ReLUs' switches,
which any lower precision flips alike: neither tells a step in fp8 from one
in bf16, where a tower's rows do. A random-initialised head's logits swing
the loss of steps 2 and 3, and the vision input BatchNorm's scale is
ill-conditioned (its gradient sums products of raw frames that cancel).
"""

from __future__ import annotations

import math
import statistics

import numpy as np
import torch

NOUGHT_GRAD = 1e-3  # a leaf's reference gradient under this share of the median leaf's is rounding


def row_errs(prog: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """|p - r| / |r| of each row; inf when the shapes differ or a row is not
    finite."""
    prog, ref = np.asarray(prog, np.float64), np.asarray(ref, np.float64)
    if prog.shape != ref.shape:
        return np.full(max(len(ref), 1), math.inf)
    err = np.linalg.norm(prog - ref, axis=1) / np.maximum(np.linalg.norm(ref, axis=1), 1e-30)
    return np.where(np.isfinite(err), err, math.inf)


def row_err(prog: np.ndarray, ref: np.ndarray) -> float:
    """Largest |p - r| / |r| over the rows."""
    return float(np.max(row_errs(prog, ref)))


def clip_err(errs: list[np.ndarray]) -> float:
    """The worst clip's median row error, over clips given as arrays of
    their rows' errors."""
    return max((float(np.median(e)) for e in errs), default=0.0)


def clip_p90(errs: list[np.ndarray]) -> float:
    """The worst clip's 90th-percentile row error."""
    return max((float(np.percentile(e, 90)) for e in errs), default=0.0)


def clip_mean(errs: list[np.ndarray]) -> float:
    """The worst clip's mean row error."""
    return max((float(np.mean(e)) for e in errs), default=0.0)


def nonfinite(rows: np.ndarray) -> bool:
    """A clip's rows hold a value that is not finite."""
    return not bool(np.all(np.isfinite(rows)))


def _norms(leaves: dict, keys) -> dict:
    return {k: float(torch.linalg.vector_norm(leaves[k].double())) for k in keys}


def leaf_gaps(prog: dict, ref: dict, keys) -> dict:
    """{leaf: | |p| - |r| | / max(|r|, median leaf's |r|)}: a leaf's gap of
    norms, against its own norm or, where that is smaller, the median
    leaf's (some gradients are all but zero); inf where not finite."""
    keys = list(keys)
    nr, npg = _norms(ref, keys), _norms(prog, keys)
    median = statistics.median(nr.values())
    gaps = {k: abs(npg[k] - nr[k]) / max(nr[k], median, 1e-30) for k in keys}
    return {k: (g if math.isfinite(g) else math.inf) for k, g in gaps.items()}


def leaf_devs(prog: dict, ref: dict, keys) -> dict:
    """{leaf: |p - r| / max(|r|, median leaf's |r|)}: a leaf's deviation;
    inf where not finite."""
    keys = list(keys)
    nr = _norms(ref, keys)
    median = statistics.median(nr.values())
    devs = {k: float(torch.linalg.vector_norm(prog[k].double() - ref[k].double())) / max(nr[k], median, 1e-30)
            for k in keys}
    return {k: (d if math.isfinite(d) else math.inf) for k, d in devs.items()}


def changed_leaves(ref_grad1: dict, params0: dict) -> list[str]:
    """The leaves whose change is compared: every running statistic, and
    every trainable leaf whose reference gradient is not nought to rounding."""
    gn = _norms(ref_grad1, ref_grad1)
    median = statistics.median(gn.values())
    return [k for k in params0 if k not in gn or gn[k] >= NOUGHT_GRAD * median]


def train_numbers(prog: dict, ref: dict, params0: dict) -> dict:
    """prog and ref: {"loss": [per step], "grad1": {leaf: tensor}, "params":
    {leaf: tensor after the steps}, "emb1": {tower: rows}}, both under the
    reference's leaf names; params0: the leaves before the first step."""
    finite = len(prog["loss"]) == len(ref["loss"]) and all(math.isfinite(x) for x in prog["loss"])
    gaps = [abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"])] if finite else [math.inf]
    grad = leaf_gaps(prog["grad1"], ref["grad1"], ref["grad1"])
    keys = changed_leaves(ref["grad1"], params0)
    delta = lambda side: {k: side["params"][k].double() - params0[k].double() for k in keys}  # noqa: E731
    change = leaf_gaps(delta(prog), delta(ref), keys)
    grad_dev = leaf_devs(prog["grad1"], ref["grad1"], ref["grad1"])
    change_dev = leaf_devs(delta(prog), delta(ref), keys)
    emb = [row_errs(prog["emb1"].get(t, np.zeros((0, 0))), ref["emb1"][t]) for t in sorted(ref["emb1"])]
    emb = np.concatenate(emb) if emb else np.full(1, math.inf)
    worst = lambda g: max(g, key=g.get)  # noqa: E731
    return {
        "emb_err": float(emb.max()),
        "emb_err_median": float(np.median(emb)),
        "loss_gap": gaps[0],
        "grad_gap": statistics.median(grad.values()),
        "grad_gap_quartiles": _quartiles(grad.values()),
        "grad_dev": statistics.median(grad_dev.values()),
        "change_gap": change[worst(change)],
        "change_dev": statistics.median(change_dev.values()),
        "loss_gap_any_step": max(gaps),
        "grad_gap_worst_leaf": grad[worst(grad)],
        "change_gap_median": statistics.median(change.values()),
        "worst": {"grad": worst(grad), "change": worst(change)},
        "left_out": sorted(set(params0) - set(keys)),
    }


def _quartiles(values) -> list[float]:
    values = [v if math.isfinite(v) else 1e30 for v in values]
    return [float(q) for q in np.percentile(values, [25, 75])] if values else [math.inf, math.inf]


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}}); a
    number that is missing or not finite fails."""
    table, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name, math.inf)
        value = value if isinstance(value, (int, float)) and math.isfinite(value) else math.inf
        table[name] = {"value": value, "limit": limit}
        ok = ok and value <= limit
    return ok, table
