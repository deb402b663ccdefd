"""Share, in %, of the traced train steps' device time that the train-mode
BatchNorms of both towers take, forward and backward, from the program's
own spans (``l3embedding_torch/utils/trace.py``): the device time of every
``tower.bn`` span (``models/towers.py::_bn``; its backward from the output's
gradient to the input's, marked by tensor hooks) under the traced stretch's
``train.call`` spans, over those steps' device time (``trace.share``). A
span's device time is the time between CUDA events recorded on its stream
at its enter and exit. The stretch's steps are the last ``traced_steps``
top-level ``train.call`` spans: the profiler's first start, one step, comes
before the stretch, and nothing runs under a profiler after it. None
without a traced stretch, or where the program records no such spans."""


def read(rec):
    n = rec.get("traced_steps") or 0
    if n == 0:
        return None
    try:
        from l3embedding_torch.utils import trace
    except ImportError:
        return None
    return trace.share("tower.bn", "train.call", n)
