"""Host time of ``EmbeddingExtractor.embed_audio_async`` a clip, in ms,
from the harness's span around the call: the call returns before the card
finishes, so this is the framing, the pinned upload and the launches.
Averaged over the window's clips outside the traced stretch (the profiler
slows the host there)."""


def read(rec):
    times = [c["enqueue_s"] for c in rec.get("clips", []) if not c["traced"]]
    if not times:
        return None
    return 1e3 * sum(times) / len(times)
