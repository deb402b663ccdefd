"""Share, in %, of the traced encoder calls' device time that the attention
cores take, from the program's own spans (``l3embedding_torch/utils/trace.py``):
the device time of every ``encoder.attn`` span (around each
``F.scaled_dot_product_attention`` of ``models/whisper_encoder.py``) under
the traced stretch's ``extract.call`` spans, over those calls' device time
(``trace.share``). The stretch's calls are the last ``trace_calls``
top-level ``extract.call`` spans. None without a traced stretch, or where
the program records no such spans."""


def read(rec):
    n = rec.get("trace_calls") or 0
    if n == 0:
        return None
    try:
        from l3embedding_torch.utils import trace
    except ImportError:
        return None
    return trace.share("encoder.attn", "extract.call", n)
