"""The downstream MLP on the card (``l3embedding_torch/classifier/mlp.py``)
against the same training on the CPU. Imports torch, numpy and the port
only, so it collects on the card's machine (no sklearn, no JAX there);
skips without a CUDA device. On the card:
``python -m pytest tests/test_torch_port_classifier_card.py -m cuda``."""

import numpy as np
import pytest
import torch

from l3embedding_torch.classifier import mlp
from l3embedding_torch.compat.to_jax import mlp_to_jax
from torch_port_threads import one_torch_thread  # noqa: F401


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return (a @ b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30)


def _split(seed):
    """Standardised class-structured rows: 2048 training, 512 valid, 512 test."""
    rng = np.random.RandomState(seed)
    means = rng.randn(10, 256).astype(np.float32)
    out = []
    for n in (2048, 512, 512):
        y = rng.randint(0, 10, n)
        out.append(((means[y] + 2 * rng.randn(n, 256)).astype(np.float32) / 2.2, y))
    return out


@pytest.mark.cuda
def test_mlp_on_the_card_matches_the_cpu():
    """train_mlp_torch on the card against the CPU from the same initial
    parameters (the generator draws on the CPU): per-layer cosine >= 0.9999,
    the same best epoch, the epochs' losses within 1e-5 relative (the smoke
    measures 9.7e-8 at 4096 × 6144), predict_proba rows at cosine >= 0.9999."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    (X, y), (Xv, yv), (Xs, _) = _split(3)
    runs = {}
    for device in ("cuda", "cpu"):
        model, hist = mlp.train_mlp_torch(X, y, Xv, yv, num_epochs=3, random_state=2, device=device)
        assert next(model.parameters()).device.type == device
        runs[device] = (mlp_to_jax(model), hist, mlp.predict_proba(model, Xs))
    for layer_c, layer_h in zip(runs["cuda"][0], runs["cpu"][0]):
        for k in ("w", "b"):
            assert _cos(layer_c[k], layer_h[k]) >= 0.9999, k
    assert runs["cuda"][1]["best_epoch"] == runs["cpu"][1]["best_epoch"]
    for key in ("train_loss", "valid_loss"):
        np.testing.assert_allclose(runs["cuda"][1][key], runs["cpu"][1][key], rtol=1e-5)
    assert min(_cos(a, b) for a, b in zip(runs["cuda"][2], runs["cpu"][2])) >= 0.9999


@pytest.mark.cuda
def test_mlp_keeps_the_training_set_on_the_card(monkeypatch):
    """The training rows go to the card once; every step indexes them there
    (no upload inside an epoch)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    (X, y), (Xv, yv), _ = _split(4)
    uploads = []
    real = torch.as_tensor

    def counting(data, *args, **kwargs):
        uploads.append(np.shape(data))
        return real(data, *args, **kwargs)

    monkeypatch.setattr(mlp.torch, "as_tensor", counting)
    mlp.train_mlp_torch(X, y, Xv, yv, num_epochs=2, device="cuda")
    # X, Y, Xv, Yv, then one permutation an epoch.
    assert uploads[:4] == [X.shape, (len(y), 10), Xv.shape, (len(yv), 10)]
    assert uploads[4:] == [(len(X) // 64, 64)] * 2
