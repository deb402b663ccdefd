"""The port's train step on the card against the same step on the CPU.

No JAX here, so that the file collects on a machine with a card and
without flax: both sides are the port, from one seeded init and one
seeded batch. Run there with ``python -m pytest
tests/test_torch_port_train_card.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from l3embedding_torch.compat.from_jax import bn_fed_biases
from l3embedding_torch.models.registry import build_model
from l3embedding_torch.training.state import create_train_state
from l3embedding_torch.training.steps import make_train_step


def _step(model_type, batch, device, probe=False):
    """One f32 step of a fresh seeded state → (loss, grads, TF32 flags seen
    while the backward reached the audio tower's first conv)."""
    state = create_train_state(build_model(model_type), torch.Generator().manual_seed(1), 1e-4,
                               device=device)
    seen = []
    if probe:
        tower = state.model.audio_model
        w = tower.convs[0].weight if model_type == "tiny_L3" else tower.blocks[0].conv.weight
        w.register_hook(lambda g: seen.append(torch.backends.cudnn.allow_tf32))
    state, metrics = make_train_step()(state, {k: torch.from_numpy(v).to(device) for k, v in batch.items()})
    grads = {n: p.grad.double().cpu() for n, p in state.model.named_parameters()}
    return float(metrics["loss"]), grads, seen


@pytest.mark.cuda
@pytest.mark.parametrize("model_type,batch_size", [("tiny_L3", 4), ("cnn_L3_melspec2", 2)])
def test_card_step_matches_cpu_and_keeps_tf32_off(model_type, batch_size):
    """The f32 step on the card: every gradient leaf at cosine >= 0.9999
    against the CPU's (but the conv biases that feed a train-mode BN, whose
    gradient is zero but for rounding), the loss within 1e-4, and TF32 off
    during the backward although torch's defaults are on."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.RandomState(3)
    lab = rng.randint(0, 2, batch_size)
    batch = {
        "video": rng.randint(0, 256, (batch_size, 224, 224, 3)).astype(np.uint8),
        "audio": (rng.randn(batch_size, 1, 48000) * 3000).astype(np.int16),
        "label": np.stack([lab, 1 - lab], 1).astype(np.float32),
    }
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    try:
        loss_cpu, g_cpu, _ = _step(model_type, batch, "cpu")
        loss, grads, seen = _step(model_type, batch, "cuda", probe=True)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    assert seen == [False]
    assert abs(loss - loss_cpu) <= 1e-4 * abs(loss_cpu)
    noise = bn_fed_biases(model_type)
    for name, g in grads.items():
        if name in noise:
            continue
        cos = torch.nn.functional.cosine_similarity(g.flatten(), g_cpu[name].flatten(), dim=0).item()
        assert cos >= 0.9999, (name, cos)
