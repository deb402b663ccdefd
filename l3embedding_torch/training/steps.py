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

On one device ``bn_mode="sync"`` is the plain step. ``"per_replica"``
(the reference's BN over each replica's slice) needs several devices,
which the port does not drive yet (ROADMAP.md, Queue 1 item 9).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.towers import ieee_fp32
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
    not BatchNorm scales), in f32."""
    kernels = [m.weight for m in model.modules() if isinstance(m, (nn.Conv2d, nn.Linear))]
    return WEIGHT_DECAY * sum(torch.sum(torch.square(w.float())) for w in kernels)


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


def make_train_step(accum_steps: int = 1, bn_mode: str = "sync"):
    """→ fn(state, batch) → (state, metrics), updating `state` in place.

    batch: {"video": (B, 224, 224, 3) uint8 or f32, "audio": (B, 1, 48000)
    int16 or f32, "label": (B, 2)}. metrics: {"loss": the mean
    cross-entropy, "acc", "reg_loss": the L2 term} as 0-d tensors on the
    model's device (no host sync).

    accum_steps > 1 splits the batch into that many microbatches: the
    gradients are averaged over them before one Adam update, the BatchNorm
    statistics update once per microbatch, in sequence, and the metrics are
    the mean cross-entropy and accuracy with reg_loss the L2 term of the
    parameters before the step.
    """
    if bn_mode == "per_replica":
        raise NotImplementedError(
            "bn_mode='per_replica' needs several devices; multi-GPU training is "
            "ROADMAP.md Queue 1 item 9"
        )
    if bn_mode != "sync":
        raise ValueError(f"unknown bn_mode {bn_mode!r}")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

    def train_step(state: TrainState, batch: dict):
        model, opt = state.model, state.optimizer
        device = next(model.parameters()).device
        video, audio, labels = _inputs(batch, device)
        b = labels.shape[0]
        if b % accum_steps:
            raise ValueError(f"batch size {b} not divisible by accum_steps {accum_steps}")
        mb = b // accum_steps
        opt.zero_grad(set_to_none=True)
        with _f32_step(state):
            if accum_steps == 1:
                logits = model(video, audio, train=True)
                ce, acc = _ce_acc(logits, labels)
                loss = ce + l2_penalty(model)
                loss.backward()
                reg = (loss - ce).detach()
            else:
                with torch.no_grad():
                    reg = l2_penalty(model)
                ces, accs = [], []
                for i in range(accum_steps):
                    sl = slice(i * mb, (i + 1) * mb)
                    logits = model(video[sl], audio[sl], train=True)
                    ce_i, acc_i = _ce_acc(logits, labels[sl])
                    (ce_i + l2_penalty(model)).backward()
                    ces.append(ce_i.detach())
                    accs.append(acc_i)
                for p in model.parameters():
                    p.grad.div_(accum_steps)
                ce, acc = torch.stack(ces).mean(), torch.stack(accs).mean()
            opt.step()
        state.step += 1
        return state, {"loss": ce.detach(), "acc": acc, "reg_loss": reg}

    return train_step


def make_eval_step():
    """→ fn(state, batch) → {"loss": cross-entropy + L2, "acc"}, with the
    BatchNorms on their running statistics; no update."""

    def eval_step(state: TrainState, batch: dict):
        model = state.model
        video, audio, labels = _inputs(batch, next(model.parameters()).device)
        with torch.no_grad(), _f32_step(state):
            ce, acc = _ce_acc(model(video, audio, train=False), labels)
            return {"loss": ce + l2_penalty(model), "acc": acc}

    return eval_step
