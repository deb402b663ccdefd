"""The port's spans and counters (``l3embedding_torch/utils/trace.py``): off
unless a torch.profiler records, and then the spans of the extractor, the
towers and the train step, with their parents, counters and times, and no
number changed. On the CPU at small sizes (buckets of 2, 4, 8 rows)."""

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import l3embedding_torch.embed.extract as extract
from l3embedding_torch.models.registry import build_model
from l3embedding_torch.training.state import create_train_state
from l3embedding_torch.training.steps import make_train_step
from l3embedding_torch.utils import trace

SR = 48000


@pytest.fixture(autouse=True)
def small(monkeypatch):
    monkeypatch.setattr(extract, "BUCKETS", (2, 4, 8))
    torch.set_num_threads(min(4, torch.get_num_threads()))
    trace.clear()
    yield
    trace.clear()


def _clip(seconds, seed=0):
    return (np.random.RandomState(seed).randn(int(seconds * SR)) * 0.1).astype(np.float32)


def _batch(b, seed=3):
    rng = np.random.RandomState(seed)
    lab = rng.randint(0, 2, b)
    return {"video": torch.from_numpy(rng.randint(0, 256, (b, 224, 224, 3)).astype(np.uint8)),
            "audio": torch.from_numpy((rng.randn(b, 1, SR) * 3000).astype(np.int16)),
            "label": torch.from_numpy(np.stack([lab, 1 - lab], 1).astype(np.float32))}


def _state(model_type):
    return create_train_state(build_model(model_type), torch.Generator().manual_seed(1), 1e-4, device="cpu")


def _traced(fn):
    """fn() under a CPU profiler → (fn's result, the spans, the names of the
    profiler's events)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, trace.spans(), {e.name for e in prof.events()}


def _parents(spans):
    by_id = {s.id: s for s in spans}
    return collections.Counter((s.name, by_id[s.parent].name if s.parent else None) for s in spans)


@pytest.fixture(scope="module")
def mel_extractor():
    return extract.EmbeddingExtractor(None, "cnn_L3_melspec2", "short", device="cpu")


@pytest.fixture(scope="module")
def orig_extractor():
    return extract.EmbeddingExtractor(None, "cnn_L3_orig", "original", device="cpu")


@pytest.fixture(scope="module")
def tiny_extractor():
    return extract.EmbeddingExtractor(None, "tiny_L3", "short", device="cpu")


def test_off_without_a_profiler(tiny_extractor, monkeypatch):
    """No profiler: an extraction and a train step record no span, make no
    record_function, register no tensor hook and make no CUDA event."""
    made = collections.Counter()
    real_rf, real_hook = trace.record_function, torch.Tensor.register_hook

    def rf(name):
        made["record_function"] += 1
        return real_rf(name)

    def hook(self, fn):
        made["hook"] += 1
        return real_hook(self, fn)

    def event(*args, **kwargs):
        made["event"] += 1
        raise AssertionError("a CUDA event with tracing off")

    monkeypatch.setattr(trace, "record_function", rf)
    monkeypatch.setattr(torch.Tensor, "register_hook", hook)
    monkeypatch.setattr(torch.cuda, "Event", event)
    assert not trace.on()
    tiny_extractor.embed_audio(_clip(1.2), 0.1)
    tiny_extractor.embed_audio(_clip(1.2), 0.1, device_framing=True)
    state = _state("tiny_L3")
    make_train_step()(state, _batch(4))
    make_train_step(accum_steps=2)(state, _batch(4))
    assert made == {} and trace.spans() == []


@pytest.mark.parametrize("framing", [False, True])
@pytest.mark.parametrize("model_type,bns", [("cnn_L3_melspec2", 9), ("cnn_L3_orig", 8)])
def test_extraction_spans(model_type, bns, framing, mel_extractor, orig_extractor):
    """One extract.call a public call (embed_audio_async → embed_windows_async
    nests none), its upload and forward under it, the front end and one
    tower.bn a BatchNorm under the forward: each of the tower's `bns` but
    the final one, which lies past the embedding tap; the BN spans' sum
    within the call's time; rows and bucket rows counted; each span in the
    profiler's events."""
    ext = mel_extractor if model_type == "cnn_L3_melspec2" else orig_extractor
    assert sum(isinstance(m, torch.nn.BatchNorm2d) for m in ext.model.tower.modules()) == bns
    bns -= 1
    clips = [_clip(1.2, 1), _clip(2.0, 2)]  # 3 windows in a bucket of 4, 11 in one of 16 (8 + 8)
    rows, spans, events = _traced(lambda: [ext.embed_audio(c, 0.1, device_framing=framing) for c in clips])
    assert [r.shape[0] for r in rows] == [3, 11]
    n = len(clips)
    uploads = n * (1 if framing else 2)  # host framing: the framing, then the bucket's upload
    assert _parents(spans) == {
        ("extract.call", None): n, ("extract.upload", "extract.call"): uploads,
        ("extract.forward", "extract.call"): n, ("tower.frontend", "extract.forward"): n,
        ("tower.bn", "extract.forward"): n * bns}
    calls = [s for s in spans if s.name == "extract.call"]
    assert [(c.counters["rows"], c.counters["bucket_rows"]) for c in calls] == [(3, 4), (11, 16)]
    for call in calls:
        inside = [s for s in spans if s.name == "tower.bn" and call.start_ns <= s.start_ns <= s.end_ns <= call.end_ns]
        assert len(inside) == bns
        assert 0 < sum(s.device_s for s in inside) <= call.device_s
    assert {"extract.call", "extract.upload", "extract.forward", "tower.frontend", "tower.bn"} <= events


def test_windows_call_counts_its_bucket(tiny_extractor):
    """embed_windows: one extract.call with its upload; 5 rows in a bucket
    of 8; tiny_L3's 3 BatchNorms."""
    windows = np.stack([_clip(1.0, i) for i in range(5)])
    _, spans, _ = _traced(lambda: tiny_extractor.embed_windows(windows))
    assert _parents(spans) == {
        ("extract.call", None): 1, ("extract.upload", "extract.call"): 1,
        ("extract.forward", "extract.call"): 1, ("tower.bn", "extract.forward"): 3}
    assert spans[-1].name == "extract.call" and spans[-1].counters == {"rows": 5, "bucket_rows": 8}


@pytest.fixture(scope="module")
def melspec2_steps():
    """One f32 melspec2 step at 2 pairs from one seeded state, untraced and
    traced → (untraced state, traced state, the traced spans, the
    profiler's event names)."""
    batch = _batch(2)
    plain, _ = make_train_step()(_state("cnn_L3_melspec2"), batch)
    trace.clear()
    (traced, _), spans, events = _traced(lambda: make_train_step()(_state("cnn_L3_melspec2"), batch))
    trace.clear()
    return plain, traced, spans, events


def test_train_step_spans(melspec2_steps):
    """A melspec2 step: train.call holding its forward, backward and
    update; 18 tower.bn spans in the forward and 18 in the backward, one a
    BatchNorm each; the backward ones in sequence, each within
    train.backward; the BN total within the step's time."""
    _, _, spans, events = melspec2_steps
    assert _parents(spans) == {
        ("train.call", None): 1, ("train.forward", "train.call"): 1,
        ("train.backward", "train.call"): 1, ("train.update", "train.call"): 1,
        ("tower.frontend", "train.forward"): 1,
        ("tower.bn", "train.forward"): 18, ("tower.bn", "train.backward"): 18}
    call, = [s for s in spans if s.name == "train.call"]
    backward, = [s for s in spans if s.name == "train.backward"]
    bn = [s for s in spans if s.name == "tower.bn"]
    bwd = sorted((s for s in bn if s.parent == backward.id), key=lambda s: s.start_ns)
    for a, b in zip(bwd, bwd[1:]):
        assert a.end_ns <= b.start_ns
    assert all(backward.start_ns <= s.start_ns <= s.end_ns <= backward.end_ns for s in bwd)
    assert 0 < sum(s.device_s for s in bn) <= call.device_s
    assert {"train.call", "train.forward", "train.backward", "train.update", "tower.bn"} <= events


def test_tracing_changes_no_number(melspec2_steps, mel_extractor):
    """Rows bit for bit with and without the profiler; every parameter and
    running statistic after one step equal."""
    plain, traced, _, _ = melspec2_steps
    want, got = plain.model.state_dict(), traced.model.state_dict()
    assert all(torch.equal(want[k], got[k]) for k in want)
    clip = _clip(2.0, 5)
    rows = mel_extractor.embed_audio(clip, 0.1)
    again, _, _ = _traced(lambda: mel_extractor.embed_audio(clip, 0.1))
    np.testing.assert_array_equal(rows, again)


def test_accumulated_step_spans():
    """Under accumulation each microbatch has its forward and its backward
    (3 tiny_L3 BatchNorms a tower each way); the gradients' division and
    Adam's step are updates."""
    (_, _), spans, _ = _traced(lambda: make_train_step(accum_steps=2)(_state("tiny_L3"), _batch(4)))
    assert _parents(spans) == {
        ("train.call", None): 1, ("train.forward", "train.call"): 3,
        ("train.backward", "train.call"): 2, ("train.update", "train.call"): 2,
        ("tower.bn", "train.forward"): 12, ("tower.bn", "train.backward"): 12}


def test_span_rules():
    """A span does not nest in one of its name; counters add up in the
    innermost open span of the name; the buffer keeps the last CAPACITY
    spans and clear() empties it; off, span() opens nothing."""
    assert trace.span("a") is trace.span("b")  # the shared do-nothing context
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("a"):
            trace.count("a", n=2)
            with trace.span("a"):
                trace.count("a", n=3)
                with trace.span("b"):
                    trace.count("missing", n=1)
    b, a = trace.spans()
    assert (a.name, a.parent, a.counters) == ("a", None, {"n": 5})
    assert (b.name, b.parent, b.counters) == ("b", a.id, {})
    assert a.start_ns <= b.start_ns <= b.end_ns <= a.end_ns and a.device_s == (a.end_ns - a.start_ns) / 1e9
    trace.clear()
    assert trace.spans() == [] and trace._done.maxlen == trace.CAPACITY


def test_share_reads_the_last_top_level_spans():
    """share(child, root, n): the child spans at any depth under the last n
    top-level roots, over those roots' time; a child outside them counts
    for nothing; fewer than n roots (or none asked for) give None."""
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            with trace.span("r"):
                with trace.span("c"):
                    sum(range(20000))
                with trace.span("mid"), trace.span("c"):
                    sum(range(10000))
        with trace.span("c"):
            sum(range(50000))
    spans = trace.spans()
    roots = [s for s in spans if s.name == "r"]
    assert trace.last("r", 2) == roots[1:] and trace.last("r", 4) is None and trace.last("r", 0) is None
    ids = {r.id for r in roots[1:]}
    mids = {s.id for s in spans if s.name == "mid" and s.parent in ids}
    inside = [s for s in spans if s.name == "c" and (s.parent in ids or s.parent in mids)]
    assert len(inside) == 4
    want = 100 * sum(s.device_s for s in inside) / sum(r.device_s for r in roots[1:])
    assert trace.share("c", "r", 2) == pytest.approx(want) and 0 < want < 100
    assert trace.share("c", "r", 4) is None and trace.share("c", "mid", 1) is None


def test_profile_steps_trace_holds_the_spans(tmp_path):
    """run_epochs' --profile-steps trace: the first 2 steps' data waits
    (beside data_wait_times, which counts every step) and steps are spans,
    and the exported chrome trace names them."""
    from l3embedding_torch.training.loop import run_epochs
    from l3embedding_torch.training.steps import make_eval_step

    batches = [{k: v.numpy() for k, v in _batch(4, seed).items()} for seed in range(3)]
    history, _ = run_epochs(
        _state("tiny_L3"), make_train_step(), make_eval_step(), str(tmp_path), iter(batches),
        lambda: iter(batches[:1]), num_epochs=1, train_epoch_size=3, validation_epoch_size=1,
        train_batch_size=4, async_checkpoints=False, prefetch_batches=1, profile_steps=2)
    assert len(history["data_wait_times"]) == 3
    spans = trace.spans()
    assert [s.name for s in spans if s.parent is None] == ["train.data_wait", "train.call"] * 2
    text = (tmp_path / "profile" / "trace.json").read_text()
    assert '"train.data_wait"' in text and '"train.call"' in text and '"tower.bn"' in text
