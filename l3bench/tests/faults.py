"""Faults planted under the harness by the tests (``Context.plant``): each
breaks the timed path the way a wrong optimisation could, and the run must
then come out not correct."""

from __future__ import annotations

import torch


def alter_answer(ext) -> None:
    """Extraction: every answer is altered where it is produced: the rows of
    each bucket the model produces are scaled by 1.5."""
    model = ext.models[0]
    forward = model.forward

    def altered(x):
        return forward(x) * 1.5

    model.forward = altered


def alter_one_in_three(ext) -> None:
    """Extraction: the rows of the first of every three buckets the model
    produces in the window are scaled by 1.5; the rest are right, the median
    row among them."""
    model = ext.models[0]
    forward = model.forward
    calls = [0]

    def altered(x):
        calls[0] += 1
        y = forward(x)
        return y * 1.5 if calls[0] % 3 == 1 else y

    model.forward = altered


def alter_tail(ext) -> None:
    """Extraction: the rows of each clip's last third of windows are scaled
    by 1.5, as a framing fault at a clip's end would leave them; the rest,
    the median row among them, are right."""
    embed = ext.embed_audio_async

    class Altered:
        def __init__(self, handle):
            self.handle = handle

        def result(self):
            rows = self.handle.result().copy()
            rows[len(rows) - (len(rows) + 2) // 3:] *= 1.5
            return rows

    ext.embed_audio_async = lambda *args, **kwargs: Altered(embed(*args, **kwargs))


def nan_row(ext) -> None:
    """Extraction: one row of every bucket the model produces is not a
    number."""
    model = ext.models[0]
    forward = model.forward

    def altered(x):
        y = forward(x).clone()
        y[0] = float("nan")
        return y

    model.forward = altered


def unchanged(step):
    """Training: the step computes its loss and returns the state as it
    was: parameters, statistics and the optimizer's state all restored."""

    def run(state, batch):
        saved = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
        state, metrics = step(state, batch)
        with torch.no_grad():
            for k, v in state.model.state_dict().items():
                v.copy_(saved[k])
        state.optimizer.state.clear()
        return state, metrics

    return run


def half_batch(step):
    """Training: the second half of every batch is left out, and the step's
    means are taken over the rest."""

    def run(state, batch):
        return step(state, {k: v[: v.shape[0] // 2] for k, v in batch.items()})

    return run


def half_loss(step):
    """Training: the forward runs on every row of the batch, but the loss,
    and so the gradient, is the mean over its first half alone."""
    import l3embedding_torch.training.steps as steps

    ce_acc = steps._ce_acc

    def half(logits, labels):
        n = logits.shape[0] // 2
        return ce_acc(logits[:n], labels[:n])

    def run(state, batch):
        steps._ce_acc = half
        try:
            return step(state, batch)
        finally:
            steps._ce_acc = ce_acc

    return run


def no_exchange(step):
    """Data-parallel training: nothing is exchanged between the ranks: each
    steps on its own gradient, its BatchNorms see its own rows."""
    import l3embedding_torch.models.towers as towers
    import l3embedding_torch.training.steps as steps

    steps._all_reduce_mean = lambda tensors, group: list(tensors)

    def local_moments(x, group):
        mean = x.mean((0, 2, 3))
        return mean, torch.clamp((x * x).mean((0, 2, 3)) - mean * mean, min=0.0)

    towers._batch_moments = local_moments
    return step
