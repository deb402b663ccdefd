"""AVC train and eval steps of the port (port of
``l3embedding_tpu/training/steps.py``).

  * Batches arrive in their storage dtypes (video uint8, audio int16) and
    are converted on the model's device (``preprocess_batch``).
  * L2 regularisation is Keras's kernel_regularizer: ``1e-5 · Σ w²`` over
    conv and dense kernels only, with no ½ (``l2_penalty``).
  * The loss is softmax cross-entropy with soft labels on the f32 logits,
    plus the L2 term; the eval loss includes the L2 term too (Keras's
    val_loss does).
  * BatchNorm runs in train mode in the train step: the batch's
    statistics, the running ones updated in place (``models/towers._bn``).
  * The f32 model (the parity configuration) keeps TF32 off on the card for
    the whole step, the backward pass included: ``towers.ieee_fp32`` alone
    covers only the forward.

Data parallelism (``group``, a process group of several ranks, one card
each; ``parallel/``): each rank steps on its own rows of the global batch.

  * ``bn_mode="sync"``: every train-mode BatchNorm takes its statistics
    over the global batch (``towers.sync_batch_norm``), the gradients are
    summed over the ranks and divided by their number in one flat
    all-reduce, which also carries the metrics, averaged. This is JAX's
    step on a sharded batch, independent of the number of ranks.
  * ``bn_mode="per_replica"`` (the reference's per-GPU BN, JAX's
    ``steps.py:125-170``): each rank's BatchNorms see its rows alone; the
    gradients, the new running statistics and the metrics are averaged
    over the ranks (DDP's ``broadcast_buffers`` would copy rank 0's
    statistics instead). With gradient accumulation it raises, as JAX
    does. On one rank both modes are the plain step.

With ``accum_steps > 1`` under ``sync``, microbatch i is JAX's: rows
``[i·B/k, (i+1)·B/k)`` of the global batch (the ranks' rows in rank order),
each rank taking its share of it in ``shard_batch`` order
(``_microbatch_shares``), so every BatchNorm's statistics of microbatch i
are over JAX's rows.

With ``db_batch_global`` models, the dB reference of the front end spans
the global batch as JAX's max over a sharded batch does
(``ops/frontend.batch_global_db``): the train step's BN group (none under
``per_replica``, whose replicas see their rows alone, as under JAX's
shard_map), the eval step's group.

Tensor parallelism (``group`` a ``parallel.ProcessMesh`` whose model axis
has several ranks, the state split by ``parallel.tp.tp_shard_state``): the
split layers run their own collectives over the model group
(``models/towers._conv``, ``models/avc._dense``); everything above
(BatchNorm moments, gradients, metrics, microbatches, the dB reference) is
reduced over the mesh's data group alone, for split and replicated leaves
alike, since the model ranks of one data index hold the same rows.
``l2_penalty`` sums the split kernels' squares over the model group. The
replicated parameters' gradients, which each rank of a model group computes
alone, are taken from its first rank (``_share_replicated_grads``), so
that the replicas stay equal bit for bit. ``per_replica`` refuses a model
axis, as JAX's does.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from ..models.towers import _ReduceFromModel, ieee_fp32, model_split, sync_batch_norm
from ..ops.frontend import batch_global_db
from ..parallel.distributed import comm_device
from ..parallel.mesh import ProcessMesh
from ..parallel.tp import split_leaves
from ..utils import trace
from .state import TrainState

WEIGHT_DECAY = 1e-5


def preprocess_batch(video: torch.Tensor, audio: torch.Tensor):
    """video uint8 → 2·(v/255) − 1; audio int16 → a/32768; floats pass."""
    if video.dtype == torch.uint8:
        video = 2.0 * (video.float() / 255.0) - 1.0
    if audio.dtype == torch.int16:
        audio = audio.float() / 32768.0
    return video, audio


def l2_penalty(model: nn.Module) -> torch.Tensor:
    """1e-5 · Σ w² over every nn.Conv2d and nn.Linear weight (not biases,
    not BatchNorm scales), in f32. The squares of kernels split over the
    model group are summed over it first (each slice's gradient stays its
    own)."""
    layers = [m for m in model.modules() if isinstance(m, (nn.Conv2d, nn.Linear))]
    total = sum(torch.sum(torch.square(m.weight.float())) for m in layers if model_split(m) is None)
    split = [m for m in layers if model_split(m) is not None]
    if split:
        part = sum(torch.sum(torch.square(m.weight.float())) for m in split)
        total = total + _ReduceFromModel.apply(part, model_split(split[0]).group)
    return WEIGHT_DECAY * total


def _ce_acc(logits: torch.Tensor, labels: torch.Tensor):
    ce = -(labels * F.log_softmax(logits, dim=-1)).sum(-1).mean()
    acc = (logits.argmax(-1) == labels.argmax(-1)).float().mean()
    return ce, acc


def _inputs(batch: dict, device: torch.device):
    video, audio = preprocess_batch(batch["video"].to(device), batch["audio"].to(device))
    return video, audio, batch["label"].to(device).float()


def _f32_step(state: TrainState):
    """TF32 off on the card for an f32 model, for forward and backward."""
    p = next(state.model.parameters())
    return ieee_fp32(p.is_cuda and state.model.dtype == torch.float32)


def _world(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _data_group(group, bn_mode: str = "sync"):
    """The group a step reduces over: a mesh's data group (a model axis
    refuses per_replica), or `group` itself; None for a group of one."""
    if isinstance(group, ProcessMesh):
        if group.model > 1 and bn_mode == "per_replica":
            raise ValueError("per_replica BN supports data-parallel meshes only")
        group = group.data_group
    return None if _world(group) == 1 else group


def _all_reduce_mean(tensors: list[torch.Tensor], group) -> list[torch.Tensor]:
    """Average each tensor over the group's ranks in one flat all-reduce;
    → the averaged tensors (views of the one buffer, in order)."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    flat.div_(dist.get_world_size(group))
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view(t.shape))
        i += t.numel()
    return out


def _microbatch_shares(batch: dict, accum_steps: int, group) -> dict:
    """This rank's rows for an accumulated step: of each of the accum_steps
    microbatches of the global batch (rows [i·B/k, (i+1)·B/k) of the ranks'
    rows in rank order, JAX's microbatch i), block r of n, concatenated; so
    the step's i-th slice is rank r's share of JAX's microbatch i. The rows
    are gathered from every rank first (each leaf as bytes)."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    dev = comm_device(group)
    out = {}
    for k, x in batch.items():
        x = torch.as_tensor(x)
        local = x.reshape(x.shape[0], -1).contiguous().view(torch.uint8).to(dev)
        parts = [torch.empty_like(local) for _ in range(n)]
        dist.all_gather(parts, local, group=group)
        rows = torch.cat(parts).view(x.dtype).reshape((-1,) + tuple(x.shape[1:]))
        b = rows.shape[0]
        if b % (accum_steps * n):
            raise ValueError(f"global batch {b} not divisible into {accum_steps} microbatches of {n} ranks")
        mb, share = b // accum_steps, b // accum_steps // n
        out[k] = torch.cat([rows[i * mb + r * share:i * mb + (r + 1) * share] for i in range(accum_steps)])
    return out


def _share_replicated_grads(state: TrainState, mesh: ProcessMesh) -> None:
    """Under a model axis: the replicated parameters' gradients of the
    model group's first rank on every rank of it, in one broadcast. Each
    rank computes them alone, and a backward that is not deterministic
    (cuDNN's) would let the replicas drift apart bit by bit."""
    split = split_leaves(state.model_type)
    grads = [p.grad for n, p in state.model.named_parameters() if n not in split]
    flat = torch.cat([g.reshape(-1) for g in grads]).to(comm_device(mesh.model_group))
    dist.broadcast(flat, src=mesh.data_index * mesh.model, group=mesh.model_group)
    i = 0
    for g in grads:
        g.copy_(flat[i:i + g.numel()].view(g.shape))
        i += g.numel()


def _running_stats(model: nn.Module) -> list[torch.Tensor]:
    return [b for name, b in model.named_buffers() if "running_" in name]


def _average_running_stats(model: nn.Module, group) -> None:
    """per_replica: every rank's new running statistics replaced by their
    mean over the ranks (JAX's pmean of the new batch_stats)."""
    stats = _running_stats(model)
    with torch.no_grad():
        for b, mean in zip(stats, _all_reduce_mean(stats, group)):
            b.copy_(mean)


def make_train_step(accum_steps: int = 1, bn_mode: str = "sync", group=None):
    """→ fn(state, batch) → (state, metrics), updating `state` in place.

    batch: {"video": (B, 224, 224, 3) uint8 or f32, "audio": (B, 1, 48000)
    int16 or f32, "label": (B, 2)}, this rank's rows under a group (in
    ``shard_batch`` order; with accum_steps > 1 the step redistributes them
    into JAX's microbatches).
    metrics: {"loss": the mean cross-entropy, "acc", "reg_loss": the L2
    term} as 0-d tensors on the model's device (no host sync), averaged
    over the group's ranks.

    accum_steps > 1 splits the batch into that many microbatches: the
    gradients are averaged over them before one Adam update, the BatchNorm
    statistics update once per microbatch, in sequence, and the metrics are
    the mean cross-entropy and accuracy with reg_loss the L2 term of the
    parameters before the step.

    group: a process group (``parallel.data_group()``) or a
    ``parallel.ProcessMesh`` (``create_mesh``; its data group, and a state
    split over its model axis); None or a group of one is the one-device
    step. bn_mode: module docstring.

    While tracing is on (``utils/trace.py``) a step is one ``train.call``
    span (timed on the device) holding ``train.forward``
    (the inputs' conversion through the loss; under accumulation one a
    microbatch), ``train.backward`` (one a microbatch), ``train.exchange``
    (with a group: the microbatch rows' gather, the all-reduce of the
    gradients and metrics, per_replica's running statistics, the
    replicated gradients' broadcast) and ``train.update`` (Adam's step;
    under accumulation also the gradients' division).
    """
    if bn_mode not in ("sync", "per_replica"):
        raise ValueError(f"unknown bn_mode {bn_mode!r}")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if bn_mode == "per_replica" and accum_steps > 1:
        raise NotImplementedError("per_replica BN with gradient accumulation")
    mesh = group if isinstance(group, ProcessMesh) else None
    group = _data_group(group, bn_mode)
    bn_group = group if bn_mode == "sync" else None

    def train_step(state: TrainState, batch: dict):
        device = next(state.model.parameters()).device
        with trace.span("train.call", device):
            return _step(state, batch, device)

    def _step(state: TrainState, batch: dict, device: torch.device):
        model, opt = state.model, state.optimizer
        if group is not None and accum_steps > 1:
            with trace.span("train.exchange"):
                batch = _microbatch_shares(batch, accum_steps, group)
        with _f32_step(state):
            with trace.span("train.forward"):
                video, audio, labels = _inputs(batch, device)
                b = labels.shape[0]
                if b % accum_steps:
                    raise ValueError(f"batch size {b} not divisible by accum_steps {accum_steps}")
                mb = b // accum_steps
                opt.zero_grad(set_to_none=True)
                if accum_steps == 1:
                    with sync_batch_norm(bn_group), batch_global_db(bn_group):
                        logits = model(video, audio, train=True)
                    ce, acc = _ce_acc(logits, labels)
                    loss = ce + l2_penalty(model)
                else:
                    with torch.no_grad():
                        reg = l2_penalty(model)
            if accum_steps == 1:
                with trace.span("train.backward"):
                    loss.backward()
                reg = (loss - ce).detach()
            else:
                ces, accs = [], []
                for i in range(accum_steps):
                    sl = slice(i * mb, (i + 1) * mb)
                    with trace.span("train.forward"):
                        with sync_batch_norm(bn_group), batch_global_db(bn_group):
                            logits = model(video[sl], audio[sl], train=True)
                        ce_i, acc_i = _ce_acc(logits, labels[sl])
                        loss_i = ce_i + l2_penalty(model)
                    with trace.span("train.backward"):
                        loss_i.backward()
                    ces.append(ce_i.detach())
                    accs.append(acc_i)
                with trace.span("train.update"):
                    for p in model.parameters():
                        p.grad.div_(accum_steps)
                ce, acc = torch.stack(ces).mean(), torch.stack(accs).mean()
            ce = ce.detach()
            if group is not None:
                with trace.span("train.exchange"):
                    params = list(model.parameters())
                    *grads, ce, acc, reg = _all_reduce_mean([p.grad for p in params] + [ce, acc, reg], group)
                    for p, g in zip(params, grads):
                        p.grad.copy_(g)
                    if bn_mode == "per_replica":
                        _average_running_stats(model, group)
            if mesh is not None and mesh.model > 1:
                with trace.span("train.exchange"):
                    _share_replicated_grads(state, mesh)
            with trace.span("train.update"):
                opt.step()
        state.step += 1
        return state, {"loss": ce, "acc": acc, "reg_loss": reg}

    return train_step


def make_eval_step(group=None):
    """→ fn(state, batch) → {"loss": cross-entropy + L2, "acc"}, with the
    BatchNorms on their running statistics; no update. Under a group of
    several ranks (a mesh: its data group) the metrics are averaged over
    them."""
    group = _data_group(group)

    def eval_step(state: TrainState, batch: dict):
        model = state.model
        video, audio, labels = _inputs(batch, next(model.parameters()).device)
        with torch.no_grad(), _f32_step(state), batch_global_db(group):
            ce, acc = _ce_acc(model(video, audio, train=False), labels)
            loss = ce + l2_penalty(model)
            if group is not None:
                loss, acc = _all_reduce_mean([loss, acc], group)
            return {"loss": loss, "acc": acc}

    return eval_step
