"""Share, in %, of the rows the audio tower computes in the traced
extraction calls that are bucket padding, from the program's own counters
(``l3embedding_torch/utils/trace.py``): Σ (``bucket_rows`` − ``rows``) over
Σ ``bucket_rows`` of the traced stretch's ``extract.call`` spans
(``embed/extract.py``: ``rows`` the call's real windows, ``bucket_rows``
the rows of its bucket, over all replicas). The stretch's calls are the
last ``len(trace_clips)`` top-level ``extract.call`` spans. None without a
traced stretch, or where the program records no such spans."""


def read(rec):
    n = len(rec.get("trace_clips") or ())
    if n == 0:
        return None
    try:
        from l3embedding_torch.utils import trace
    except ImportError:
        return None
    calls = trace.last("extract.call", n)
    if calls is None:
        return None
    rows = sum(s.counters.get("rows", 0) for s in calls)
    bucket = sum(s.counters.get("bucket_rows", 0) for s in calls)
    return 100.0 * (bucket - rows) / bucket if bucket > 0 else None
