"""Mixes of kind ``"avc_batches"``: a pool of distinct global batches of
audio-video pairs in the storage types of the sample factory (uint8
frames, int16 PCM, one-hot float32 labels, half of the pairs positive),
made in bulk on the device from the seed. The same seed gives the same
batches on the same kind of device, whichever rank makes them.
"""

from __future__ import annotations

import torch

from ..generate import torch_generator


def global_rows(mix: dict, world: int) -> int:
    """Pairs in one global batch: the mix's rows a card times the cards."""
    return int(mix["rows_per_card"]) * int(world)


def avc_pool(mix: dict, seed: int, device, world: int, keep: range | None = None) -> list[dict]:
    """The pool of `mix["pool"]` global batches of `global_rows` pairs,
    made on `device` from the seed, as device tensors; `keep` keeps some
    of them (default: all). Every batch is drawn in turn, so a batch's
    numbers do not depend on which the caller keeps."""
    n, b = int(mix["pool"]), global_rows(mix, world)
    h, w, c = mix["video_shape"]
    g = torch_generator(seed, device)
    keep = keep if keep is not None else range(n)
    out = []
    for i in range(n):
        video = torch.randint(0, 256, (b, h, w, c), generator=g, device=device, dtype=torch.uint8)
        audio = torch.randn((b, 1, int(mix["audio_samples"])), generator=g, device=device)
        # Half of every batch positive, in an order the seed sets.
        label = (torch.randperm(b, generator=g, device=device) < b // 2).long()
        if i in keep:
            audio = (audio * float(mix["audio_scale"])).clamp_(-32768, 32767).to(torch.int16)
            out.append({"video": video, "audio": audio, "label": torch.stack([label, 1 - label], 1).float()})
    return out
