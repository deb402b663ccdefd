"""Share of its roofline that the encoder's attention core reaches, in %,
whatever kernel SDPA picks: its operations (``counts_whisper.attn_flops``
a window, for every window of each traced call's bucket, padding rows
included: the kernel computes them) at the bf16 peak (989 TFLOP/s), over
the device time of the ``encoder.attn`` spans under the traced stretch's
``extract.call`` spans (the program's own spans, timed by CUDA events
around each call of the core). The core is compute-bound at these shapes:
q, k, v and the output are 4 · 1500 · 1280 · 2 bytes a window a block
against 4 · 1500² · 1280 operations. None without a traced stretch, or
where the program records no such spans."""

from l3bench import counts, counts_whisper


def read(rec):
    n = rec.get("trace_calls") or 0
    if n == 0:
        return None
    try:
        from l3embedding_torch.utils import trace
    except ImportError:
        return None
    every = trace.spans()
    calls = trace.last("extract.call", n, every)
    if calls is None:
        return None
    ids, parent = {s.id for s in calls}, {s.id: s.parent for s in every}

    def under(s):
        p = s.parent
        while p is not None and p not in ids:
            p = parent.get(p)
        return p is not None

    seconds = sum(s.device_s for s in every if s.name == "encoder.attn" and under(s))
    windows = sum(s.counters.get("bucket_rows", 0) for s in calls)
    if seconds <= 0 or windows == 0:
        return None
    flops = windows * counts_whisper.attn_flops(rec["config"])
    return 100.0 * flops / (seconds * counts.PEAK_FLOPS[rec["cell"]["precision"]])
