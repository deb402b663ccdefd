"""The numbers that decide ``correct`` read what they are meant to read."""

import numpy as np
import torch

from l3bench import check


def test_clip_err_reads_the_worst_clip_and_not_a_lone_row():
    good = [np.full(31, 1e-6) for _ in range(11)]
    lone = np.full(31, 1e-6)
    lone[4] = 1e-2  # one window over a near-zero STFT bin
    assert check.clip_err(good + [lone]) == 1e-6
    assert check.clip_err(good + [np.full(31, 1e-3)]) == 1e-3
    assert check.clip_err([]) == 0.0


def test_the_tail_of_a_clip_shows_where_its_median_does_not():
    tail = np.full(91, 1e-3)
    tail[-31:] = 0.5  # the last third of the clip's windows wrong
    assert check.clip_err([tail]) == 1e-3
    assert check.clip_p90([tail]) == 0.5
    assert abs(check.clip_mean([tail]) - (60e-3 + 31 * 0.5) / 91) < 1e-12
    lone = np.full(91, 1e-3)
    lone[0] = 0.5  # one far row: the 90th percentile stays, the mean moves
    assert check.clip_p90([lone]) == 1e-3 and check.clip_mean([lone]) > 5e-3
    assert check.clip_p90([]) == 0.0 and check.clip_mean([]) == 0.0


def test_nonfinite_rows():
    rows = np.ones((3, 4), np.float32)
    assert not check.nonfinite(rows)
    rows[1, 2] = np.inf
    assert check.nonfinite(rows)


def test_deviation_sees_noise_that_keeps_the_norm():
    # p = r + 0.1 n with n orthogonal to r and as long: the norms differ by
    # about 0.005 of |r|, the leaves by 0.1.
    r = torch.tensor([1.0, 0.0, 0.0, 0.0])
    p = torch.tensor([1.0, 0.1, 0.0, 0.0])
    gap = check.leaf_gaps({"a": p}, {"a": r}, ["a"])["a"]
    dev = check.leaf_devs({"a": p}, {"a": r}, ["a"])["a"]
    assert abs(gap - (np.sqrt(1.01) - 1)) < 1e-6 and abs(dev - 0.1) < 1e-6


def test_small_leaves_are_measured_against_the_median_leaf():
    ref = {"a": torch.ones(4), "b": torch.ones(4), "c": torch.full((4,), 1e-6)}
    prog = {**ref, "c": torch.full((4,), 2e-6)}
    dev = check.leaf_devs(prog, ref, ref)
    assert dev["c"] < 1e-5 and dev["a"] == 0.0
