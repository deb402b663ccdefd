"""Downstream MLP classifier in torch (port of
``l3embedding_tpu/classifier/mlp.py``).

Replaces the reference's Keras MLP (reference classifier/train.py:230-391):
Dense 512 → 128 → num_classes with ReLU, L2 1e-5 on the kernels, Adam,
early stopping with patience on val_loss, the best epoch's weights
restored before evaluation. The whole training set lives on the device;
each step takes its minibatch there by index, and an epoch's losses and
accuracies are summed on the device and read once an epoch.

Step for step the semantics are JAX's: the validation split and every
epoch's permutation come from one ``np.random.RandomState(random_state)``,
the loss is mean softmax cross-entropy plus ``weight_decay * Σ‖w‖²`` over
the kernels only (not torch Adam's ``weight_decay=``, which would add
``wd·p`` to every parameter's gradient), and Adam's eps sits outside the
square root as in optax. The He-normal init draws from a
``torch.Generator`` seeded with random_state, not from
``jax.random.PRNGKey``; ``compat/from_jax.py::mlp_from_jax`` starts the
port from JAX's initial parameters.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch
from torch import nn

LOGGER = logging.getLogger("l3embedding_torch.classifier")


class MLP(nn.Module):
    """Dense layers input_dim → *hidden → num_classes, ReLU between."""

    def __init__(self, input_dim: int, num_classes: int = 10, hidden=(512, 128)):
        super().__init__()
        dims = [input_dim, *hidden, num_classes]
        self.layers = nn.ModuleList(nn.Linear(d_in, d_out) for d_in, d_out in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers[:-1]:
            x = torch.relu(layer(x))
        return self.layers[-1](x)

    def l2(self) -> torch.Tensor:
        """Σ‖w‖² over the kernels (the biases take no decay)."""
        return sum(layer.weight.square().sum() for layer in self.layers)


def init_mlp_params(generator: torch.Generator, input_dim: int, num_classes: int = 10,
                    hidden=(512, 128)) -> MLP:
    """An MLP on the CPU with He-normal kernels, drawn as (in, out) from
    `generator` layer by layer, and zero biases."""
    model = MLP(input_dim, num_classes, hidden)
    with torch.no_grad():
        for layer in model.layers:
            d_out, d_in = layer.weight.shape
            w = torch.randn((d_in, d_out), generator=generator) * np.sqrt(2.0 / d_in)
            layer.weight.copy_(w.T)
            layer.bias.zero_()
    return model


def _loss_fn(model: MLP, x, y_onehot, weight_decay):
    logits = model(x)
    ce = -(y_onehot * torch.log_softmax(logits, -1)).sum(-1).mean()
    return ce + weight_decay * model.l2(), logits


def _accuracy(logits, y_onehot):
    return (logits.argmax(-1) == y_onehot.argmax(-1)).float().mean()


def train_mlp_torch(
    X_train,
    y_train,
    X_valid=None,
    y_valid=None,
    num_classes=10,
    batch_size=64,
    num_epochs=100,
    valid_split=0.15,
    patience=20,
    learning_rate=1e-4,
    weight_decay=1e-5,
    random_state=12345678,
    verbose=False,
    device: str | torch.device = "cuda",
):
    """Train on `device`; returns (the MLP with the best epoch's weights,
    history dict).

    history keys: train_loss, valid_loss, train_acc, valid_acc (one entry
    per epoch up to early stop), best_epoch, and epoch_seconds (host clock
    from an epoch's first step to its numbers on the host).
    """
    rng = np.random.RandomState(random_state)
    if X_valid is None:
        n = len(X_train)
        idx = rng.permutation(n)
        n_valid = int(n * valid_split)
        X_valid, y_valid = X_train[idx[:n_valid]], y_train[idx[:n_valid]]
        X_train, y_train = X_train[idx[n_valid:]], y_train[idx[n_valid:]]

    def onehot(y):
        return np.eye(num_classes, dtype=np.float32)[np.asarray(y, dtype=int)]

    device = torch.device(device)
    Xt = torch.as_tensor(np.asarray(X_train, np.float32), device=device)
    Yt = torch.as_tensor(onehot(y_train), device=device)
    Xv = torch.as_tensor(np.asarray(X_valid, np.float32), device=device)
    Yv = torch.as_tensor(onehot(y_valid), device=device)

    model = init_mlp_params(torch.Generator().manual_seed(random_state), X_train.shape[1],
                            num_classes).to(device)
    opt = torch.optim.Adam(model.parameters(), lr=learning_rate, eps=1e-8)

    n_batches = max(1, len(X_train) // batch_size)
    history = {"train_loss": [], "valid_loss": [], "train_acc": [], "valid_acc": [],
               "epoch_seconds": []}
    best_val = np.inf
    best_state = {k: v.clone() for k, v in model.state_dict().items()}
    best_epoch = 0
    since_best = 0

    for epoch in range(num_epochs):
        t0 = time.perf_counter()
        perm = rng.permutation(n_batches * batch_size) % len(X_train)
        perm = torch.as_tensor(perm.reshape(n_batches, batch_size), device=device)
        loss_sum = torch.zeros((), device=device)
        acc_sum = torch.zeros((), device=device)
        for idx in perm:
            xb, yb = Xt.index_select(0, idx), Yt.index_select(0, idx)
            loss, logits = _loss_fn(model, xb, yb, weight_decay)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            loss_sum += loss.detach()
            acc_sum += _accuracy(logits.detach(), yb)
        with torch.no_grad():
            va_loss, va_logits = _loss_fn(model, Xv, Yv, weight_decay)
            va_acc = _accuracy(va_logits, Yv)
        tr_loss, tr_acc, va_loss, va_acc = torch.stack(
            [loss_sum / n_batches, acc_sum / n_batches, va_loss, va_acc]).tolist()
        history["train_loss"].append(tr_loss)
        history["train_acc"].append(tr_acc)
        history["valid_loss"].append(va_loss)
        history["valid_acc"].append(va_acc)
        history["epoch_seconds"].append(time.perf_counter() - t0)
        if verbose:
            LOGGER.info(
                "Epoch %d: loss=%.4f acc=%.4f val_loss=%.4f val_acc=%.4f",
                epoch, tr_loss, tr_acc, va_loss, va_acc,
            )
        if va_loss < best_val:
            best_val = va_loss
            best_state = {k: v.clone() for k, v in model.state_dict().items()}
            best_epoch = epoch
            since_best = 0
        else:
            since_best += 1
            if since_best > patience:
                break

    model.load_state_dict(best_state)
    history["best_epoch"] = best_epoch
    return model, history


def predict_proba(model: MLP, X, batch_size=4096) -> np.ndarray:
    """Softmax of the MLP's logits, in chunks of batch_size rows, on the
    device that holds the model."""
    device = next(model.parameters()).device
    out = []
    with torch.no_grad():
        for i in range(0, len(X), batch_size):
            x = torch.as_tensor(np.asarray(X[i: i + batch_size], np.float32), device=device)
            out.append(torch.softmax(model(x), -1).cpu().numpy())
    return np.concatenate(out)
