"""The readers of the program's own spans and counters (``bn_share.extract``,
``bn_share.train``, ``padding_share.extract``), and the idle gaps named by
those spans, on the CPU at small sizes."""

import os
import sys
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from l3bench import run, traces

READERS = ("bn_share.extract", "bn_share.train", "padding_share.extract")
TRAIN = {"mix": {"rows_per_card": 2, "pool": 4, "prefetch": 1},
         "cell": {"precision": "f32", "warmup_s": 0, "trace": {"start": 0, "units": 2}}}


@pytest.fixture(autouse=True)
def small(monkeypatch):
    import l3embedding_torch.embed.extract as extract
    from l3embedding_torch.utils import trace

    monkeypatch.setattr(extract, "BUCKETS", (2, 4, 8))
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    trace.clear()
    yield
    trace.clear()


def test_traced_extraction_reports_the_program_metrics():
    """linear.extract.f32 traced on the CPU: 1.2 s clips are 3 windows in a
    bucket of 4, so a quarter of the rows are padding; the BatchNorms take
    a share of the calls."""
    result = run.measure("linear.extract.f32", 2**31 + 1, 0.3, True, device="cpu", overrides={
        "mix": {"lengths": {"fixed": [[1.2, 3]]}, "pool_seconds": 4},
        "cell": {"warmup_s": 0, "trace": {"start": 0, "units": 2}, "check": {"sample": 1, "limits": {"clip_err": 5e-5}}}})
    metrics = result["metrics"]
    assert metrics["padding_share.extract"] == {"value": 25.0, "unit": "%"}
    assert 0 < metrics["bn_share.extract"]["value"] < 100
    assert "bn_share.train" not in metrics


def test_traced_training_reports_the_bn_share():
    result = run.measure("mel256.train.bf16", 2**31 + 7, 0.3, True, device="cpu", overrides=TRAIN)
    assert result["correct"], result["checks"]
    assert 0 < result["metrics"]["bn_share.train"]["value"] < 100
    assert not {"bn_share.extract", "padding_share.extract"} & set(result["metrics"])


def test_a_program_span_names_the_gap_inside_the_harness_span():
    """traces.reduce names an idle gap by the innermost span named
    ``extract.*``: the program's upload inside the harness's enqueue."""
    from l3embedding_torch.utils import trace

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(traces.STRETCH), record_function("extract.enqueue"):
            with trace.span("extract.upload"):
                time.sleep(0.05)
    labels = [label for label, _, _ in traces.reduce(prof)["gaps"]]
    assert labels == ["extract.upload"]


@pytest.mark.parametrize("metric", READERS)
def test_readers_give_nothing_without_spans(metric, monkeypatch):
    """No spans recorded, no traced stretch, or no trace module in the
    program (one older than its spans): None."""
    read = run.reader(metric)
    rec = {"trace_clips": [{}, {}], "traced_steps": 2}
    assert read(rec) is None
    assert read({}) is None
    import l3embedding_torch.utils as utils

    monkeypatch.delattr(utils, "trace")
    monkeypatch.setitem(sys.modules, "l3embedding_torch.utils.trace", None)
    assert read(rec) is None
