"""Each fault a cell can have, planted under the harness, makes its run
come out not correct, where the same run without it comes out correct.
The runs skip the look for a card and drive everything else on the CPU at
a small size: a few short clips, or batches of 2 pairs a rank (training
in float32 there, so that only the fault stands between the run and its
limits). Data-parallel runs of the training cell go through the launch of
its ranks under torch.distributed.run, with two ranks over gloo, as a cell
on four cards launches them."""

import argparse
import json
import os

import pytest
import torch

from l3bench import run

FAULTS = "l3bench.tests.faults:"
SEED = 2**31 + 99
TRAIN = {"mix": {"rows_per_card": 2, "pool": 4, "prefetch": 1}, "cell": {"precision": "f32", "warmup_s": 0}}


@pytest.fixture(autouse=True)
def small_buckets(monkeypatch):
    import l3embedding_torch.embed.extract as extract

    monkeypatch.setattr(extract, "BUCKETS", (2, 4, 8))
    torch.set_num_threads(min(4, os.cpu_count() or 1))


def _extract(workload, plant=None, sample=3):
    return run.measure(workload, SEED, 0.5, False, device="cpu", plant=plant, overrides={
        "mix": {"lengths": {"fixed": [[1.2, 3]]}, "pool_seconds": 4},
        "cell": {"warmup_s": 0, "check": {**run.load_cell(workload)[2]["check"], "sample": sample}}})


@pytest.mark.parametrize("workload", ["mel256.extract.bf16", "linear.extract.f32"])
def test_an_altered_answer_fails(workload):
    assert _extract(workload)["correct"]
    result = _extract(workload, FAULTS + "alter_answer")
    assert not result["correct"]
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("workload", ["mel256.extract.bf16", "linear.extract.f32"])
def test_a_third_of_the_answers_altered_fails(workload):
    # Every clip of the window is compared; the median row is a right one.
    result = _extract(workload, FAULTS + "alter_one_in_three", sample=10**6)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("workload", ["mel256.extract.bf16", "linear.extract.f32"])
def test_the_tail_windows_of_each_clip_altered_fails(workload):
    # A third of each clip's rows are wrong: the median row is a right one.
    result = _extract(workload, FAULTS + "alter_tail")
    assert not result["correct"], result["checks"]
    assert result["checks"]["clip_err"]["value"] <= result["checks"]["clip_err"]["limit"]


def test_a_row_that_is_not_a_number_counts_as_failed():
    result = _extract("linear.extract.f32", FAULTS + "nan_row", sample=1)
    assert result["failed"] > 0 and not result["correct"]


@pytest.mark.parametrize("fault", [None, "unchanged", "half_batch", "half_loss"])
def test_a_broken_step_fails(fault):
    result = run.measure("mel256.train.bf16", SEED, 0.3, False, device="cpu", plant=fault and FAULTS + fault,
                         overrides=TRAIN)
    assert result["correct"] == (fault is None), result["checks"]


@pytest.mark.parametrize("fault", [None, "unchanged", "half_batch", "half_loss", "no_exchange"])
def test_a_broken_data_parallel_step_fails(fault, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    args = argparse.Namespace(workload="mel256.train.bf16", seed=SEED, seconds=0.3, trace=0)
    overrides = {**TRAIN, "world": 2}
    extra = ["--device", "cpu", "--overrides", json.dumps(overrides)]
    result = run.launch_ranks(args, 2, tuple(extra + (["--plant", FAULTS + fault] if fault else [])))
    assert result["correct"] == (fault is None), result["checks"]
    assert set(result["metrics"]) == {"setup_s", "pairs_per_s"} and not result["forbidden"]
    assert result["device"]["count"] == 2
