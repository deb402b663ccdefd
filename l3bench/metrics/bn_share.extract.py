"""Share, in %, of the traced extraction calls' device time that the audio
tower's BatchNorms take, from the program's own spans
(``l3embedding_torch/utils/trace.py``): the device time of every
``tower.bn`` span (``models/towers.py::_bn``, its f32 casts in and out
included) under the traced stretch's ``extract.call`` spans, over those
calls' device time (``trace.share``). A span's device time is the time
between CUDA events recorded on its stream at its enter and exit. The
stretch's calls are the last ``len(trace_clips)`` top-level
``extract.call`` spans: the profiler's first start, one call, comes before
the stretch, and nothing runs under a profiler after it. None without a
traced stretch, or where the program records no such spans."""


def read(rec):
    n = len(rec.get("trace_clips") or ())
    if n == 0:
        return None
    try:
        from l3embedding_torch.utils import trace
    except ImportError:
        return None
    return trace.share("tower.bn", "extract.call", n)
