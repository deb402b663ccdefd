"""Carry the port's AVC model and Adam state back into flax's trees, the
reverse of ``compat/from_jax.py`` (same leaf table, ``avc_leaves``).

Every function returns numpy copies (taken when it is called, so a later
in-place update of the model or the optimiser does not reach them) in
the layout that ``flax.serialization.to_state_dict`` gives the JAX
package's ``AVCTrainState``: conv kernels OIHW → HWIO, dense kernels
(out, in) → (in, out), BN weight/bias/running_mean/running_var →
scale/bias/mean/var, and torch Adam's ``exp_avg``/``exp_avg_sq``/``step``
→ optax.adam's ``mu``/``nu``/``count`` (int32). ``mlp_to_jax`` gives the
downstream MLP's parameters in the JAX package's list layout.
"""

from __future__ import annotations

import numpy as np
import torch

from .from_jax import avc_leaves


def _host(t: torch.Tensor, layout) -> np.ndarray:
    a = t.detach().to("cpu", torch.float32, copy=True).numpy()
    if layout == "conv":
        return np.ascontiguousarray(a.transpose(2, 3, 1, 0))  # OIHW → HWIO
    if layout == "dense":
        return np.ascontiguousarray(a.T)  # (out, in) → (in, out)
    return a


def _put(tree: dict, path: tuple, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def avc_to_jax_variables(model: torch.nn.Module, model_type: str) -> dict:
    """The AVCModel's weights → flax {"params": ..., "batch_stats": ...}."""
    tensors = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    out = {"params": {}, "batch_stats": {}}
    for name, coll, path, layout in avc_leaves(model_type):
        _put(out[coll], path, _host(tensors[name], layout))
    return out


def adam_to_jax(model: torch.nn.Module, model_type: str,
                optimizer: torch.optim.Optimizer) -> dict:
    """A torch Adam over ``model.parameters()`` → optax.adam's state tree.
    Before the first step torch holds no state: zeros and count 0, which is
    what ``optax.adam(...).init`` gives."""
    leaves = {name: (path, layout) for name, coll, path, layout in avc_leaves(model_type)
              if coll == "params"}
    mu, nu, steps = {}, {}, set()
    for name, p in model.named_parameters():
        path, layout = leaves[name]
        st = optimizer.state.get(p) or {}
        steps.add(int(st["step"]) if "step" in st else 0)
        _put(mu, path, _host(st.get("exp_avg", torch.zeros_like(p)), layout))
        _put(nu, path, _host(st.get("exp_avg_sq", torch.zeros_like(p)), layout))
    if len(steps) != 1:
        raise ValueError(f"Adam state: parameters disagree on the step count: {sorted(steps)}")
    return {"0": {"count": np.asarray(steps.pop(), np.int32), "mu": mu, "nu": nu}, "1": {}}


def mlp_to_jax(model: torch.nn.Module) -> list:
    """A ``classifier.mlp.MLP`` → the JAX package's MLP parameters,
    ``[{"w": (in, out), "b": (out,)}, ...]`` as numpy (its ``model.pkl``
    layout)."""
    return [{"w": _host(layer.weight, "dense"), "b": _host(layer.bias, None)} for layer in model.layers]
