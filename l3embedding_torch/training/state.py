"""Training state of the port (port of ``l3embedding_tpu/training/state.py``):
the step, the AVC model (parameters and BatchNorm statistics) and its
optimiser.

The optimiser is ``torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8)``,
the update of ``optax.adam(lr, 0.9, 0.999, 1e-8)`` (eps_root 0), the
reference's Keras 2.0.9 Adam defaults. L2 regularisation enters through
the loss (``steps.l2_penalty``), never as Adam's weight_decay.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models.avc import AVCModel
from ..models.registry import ModelSpec


@dataclass
class TrainState:
    """step counts optimiser updates; the model and the optimiser are
    updated in place by each train step."""

    step: int
    model: AVCModel
    optimizer: torch.optim.Adam
    model_type: str


def make_optimizer(model: torch.nn.Module, learning_rate: float) -> torch.optim.Adam:
    return torch.optim.Adam(model.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)


def create_train_state(
    spec: ModelSpec,
    generator: torch.Generator,
    learning_rate: float,
    compute_dtype: torch.dtype = torch.float32,
    device: str | torch.device = "cuda",
    db_batch_global: bool = False,
) -> TrainState:
    """A fresh state: the AVC model of `spec` with He-normal kernels drawn
    from `generator` (not flax's numbers), f32 parameters on `device`, and
    an Adam with no state yet (zeros, count 0, once written out)."""
    model = spec.module(compute_dtype, db_batch_global)
    model.reset_parameters(generator)
    model = model.to(device)
    return TrainState(0, model, make_optimizer(model, learning_rate), spec.name)
