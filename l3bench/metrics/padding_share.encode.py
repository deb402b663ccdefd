"""Share, in %, of the samples the encoder takes in the traced calls that
are zeros padding clips out to whole 30 s windows, from the program's own
counters (``l3embedding_torch/utils/trace.py``): Σ ``pad_samples`` over
Σ ``windows`` × the window's samples, of the traced stretch's
``extract.call`` spans (``embed/whisper.py``). The stretch's calls are the
last ``trace_calls`` top-level ``extract.call`` spans. None without a
traced stretch, or where the program records no such counters."""


def read(rec):
    n = rec.get("trace_calls") or 0
    if n == 0:
        return None
    try:
        from l3embedding_torch.utils import trace
    except ImportError:
        return None
    calls = trace.last("extract.call", n)
    if calls is None:
        return None
    windows = sum(s.counters.get("windows", 0) for s in calls)
    pad = sum(s.counters.get("pad_samples", 0) for s in calls)
    return 100.0 * pad / (windows * rec["config"]["n_samples"]) if windows > 0 else None
