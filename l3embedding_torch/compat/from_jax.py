"""Carry JAX/flax AVC variables and optimiser state into the port's modules.

Each function takes flax variables as numpy arrays, ``{"params": ...,
"batch_stats": ...}`` (the full AVC tree, or for the tower functions the
tower's own subtree), and returns a state dict:

  * ``from_jax_variables(variables, model_type)`` → the audio tower's;
  * ``vision_from_jax_variables(variables, model_type)`` → the vision tower's;
  * ``avc_from_jax_variables(variables, model_type)`` → the whole AVCModel's;
  * ``adam_from_jax(opt_state, model, optimizer)`` loads ``optax.adam``'s
    state into a ``torch.optim.Adam`` over ``model.parameters()``;
  * ``block1_conv_from_jax(w_hwio, scale, shift)`` → the block-1 probe
    kernel's operands (not a state dict).
  * ``vggish_from_jax(params)`` → the VGGish module's (flax VGGish params).
  * ``mlp_from_jax(params)`` → the downstream classifier's MLP (not a
    state dict): JAX's ``[{"w": (in, out), "b": (out,)}, ...]`` list.

Naming follows flax's auto-names. In a full tower ``ConvBNRelu_{i}/{Conv_0,
BatchNorm_0}`` are the blocks and ``{audio,vision}_embedding_layer`` the
embedding conv; ``BatchNorm_0`` is the input BN and ``BatchNorm_1`` the
final BN, except where the tower has no input BN (cnn_L3_orig), where the
final BN is ``BatchNorm_0``. In a tiny tower the convs are ``Conv_0``,
``Conv_1``, ``embedding_conv`` and the BNs ``BatchNorm_0..2``. Conv kernels
go from HWIO to OIHW, dense kernels from (in, out) to (out, in); BN
scale/bias/mean/var go to weight/bias/running_mean/running_var.
``avc_leaves`` is that table, leaf by leaf; ``compat/to_jax.py`` reads it
the other way. ``bn_fed_biases`` names the conv biases that feed a BatchNorm
(their train-mode gradient is zero but for rounding).

optax.adam's state, as ``flax.serialization.to_state_dict`` lays it out:
``{"0": {"count": int32 (), "mu": <params tree>, "nu": <params tree>},
"1": {}}`` (``ScaleByAdamState`` and the ``EmptyState`` of the learning-rate
scale). ``mu``/``nu`` are torch's ``exp_avg``/``exp_avg_sq``; ``count`` is
every parameter's ``step``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.registry import ModelSpec, build_model

# Per layer kind: (torch attribute, flax collection, flax leaf, layout).
_KIND_LEAVES = {
    "conv": (("weight", "params", "kernel", "conv"), ("bias", "params", "bias", None)),
    "dense": (("weight", "params", "kernel", "dense"), ("bias", "params", "bias", None)),
    "bn": (("weight", "params", "scale", None), ("bias", "params", "bias", None),
           ("running_mean", "batch_stats", "mean", None),
           ("running_var", "batch_stats", "var", None)),
}


def _tower_layers(spec: ModelSpec, input_bn: bool, embedding: str) -> list:
    """(flax scope path, torch module prefix, kind) of one tower's layers."""
    if spec.tiny:
        out = []
        for i, conv in enumerate(("Conv_0", "Conv_1", "embedding_conv")):
            out += [((conv,), f"convs.{i}", "conv"), ((f"BatchNorm_{i}",), f"bns.{i}", "bn")]
        return out
    out = [(("BatchNorm_0",), "input_bn", "bn")] if input_bn else []
    for i in range(7):
        out += [((f"ConvBNRelu_{i}", "Conv_0"), f"blocks.{i}.conv", "conv"),
                ((f"ConvBNRelu_{i}", "BatchNorm_0"), f"blocks.{i}.bn", "bn")]
    out += [((embedding,), "embedding_conv", "conv"),
            ((f"BatchNorm_{int(input_bn)}",), "final_bn", "bn")]
    return out


def _leaves(layers) -> list:
    return [(f"{prefix}.{attr}", coll, scope + (leaf,), layout)
            for scope, prefix, kind in layers
            for attr, coll, leaf, layout in _KIND_LEAVES[kind]]


def tower_leaves(model_type: str, tower: str) -> list:
    """[(torch name, flax collection, flax path, layout)] of the 'audio' or
    'vision' tower, paths relative to the tower; layout 'conv', 'dense' or
    None (as is)."""
    spec = build_model(model_type)
    if tower == "audio":
        layers = _tower_layers(spec, spec.audio_frontend != "linear", "audio_embedding_layer")
    else:
        layers = _tower_layers(spec, spec.vision_input_bn, "vision_embedding_layer")
    return _leaves(layers)


def avc_leaves(model_type: str) -> list:
    """[(torch name, flax collection, flax path, layout)] of the whole AVC
    model, in no particular order."""
    out = []
    for tower in ("audio", "vision"):
        out += [(f"{tower}_model.{name}", coll, (f"{tower}_model",) + path, layout)
                for name, coll, path, layout in tower_leaves(model_type, tower)]
    return out + _leaves([(("merge_dense",), "merge_dense", "dense"),
                          (("output_dense",), "output_dense", "dense")])


def bn_fed_biases(model_type: str) -> dict:
    """{torch name of a conv bias: torch name of the bias of the BatchNorm
    that conv feeds}, over the whole AVC model, for every conv whose output
    goes straight into a BatchNorm. In train mode the BN takes the batch
    mean out, so such a bias has a gradient that is zero but for rounding.
    Vision block 1's second conv is not one: its ReLU comes before the BN
    (``L3VisionTower``'s relu_before_bn)."""
    spec = build_model(model_type)
    out = {}
    for tower, input_bn in (("audio", spec.audio_frontend != "linear"),
                            ("vision", spec.vision_input_bn)):
        layers = _tower_layers(spec, input_bn, "")
        for (_, conv, kind), (_, bn, next_kind) in zip(layers, layers[1:]):
            relu_first = not spec.tiny and tower == "vision" and conv == "blocks.1.conv"
            if kind == "conv" and next_kind == "bn" and not relu_first:
                out[f"{tower}_model.{conv}.bias"] = f"{tower}_model.{bn}.bias"
    return out


def to_torch_layout(a, layout) -> torch.Tensor:
    """A flax leaf (numpy) → an f32 tensor in the torch layout."""
    a = np.asarray(a)
    if layout == "conv":
        a = a.transpose(3, 2, 0, 1)  # HWIO → OIHW
    elif layout == "dense":
        a = a.T  # (in, out) → (out, in)
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _get(tree: dict, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def _subtree(variables_np: dict, name: str) -> dict:
    p, s = variables_np["params"], variables_np["batch_stats"]
    if name in p:
        p, s = p[name], s[name]
    return {"params": p, "batch_stats": s}


def _state_dict(variables_np: dict, leaves) -> dict:
    sd = {}
    for name, coll, path, layout in leaves:
        sd[name] = to_torch_layout(_get(variables_np[coll], path), layout)
        if name.endswith(".running_var"):
            sd[name[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd


def from_jax_variables(variables_np: dict, model_type: str) -> dict:
    """flax {"params", "batch_stats"} → the audio tower's state dict."""
    return _state_dict(_subtree(variables_np, "audio_model"), tower_leaves(model_type, "audio"))


def vision_from_jax_variables(variables_np: dict, model_type: str) -> dict:
    """flax {"params", "batch_stats"} → the vision tower's state dict."""
    return _state_dict(_subtree(variables_np, "vision_model"), tower_leaves(model_type, "vision"))


def avc_from_jax_variables(variables_np: dict, model_type: str) -> dict:
    """Full flax AVC variables → the AVCModel's state dict."""
    return _state_dict(variables_np, avc_leaves(model_type))


def adam_from_jax(opt_state_np: dict, model: torch.nn.Module, model_type: str,
                  optimizer: torch.optim.Optimizer) -> None:
    """Load optax.adam's state (numpy, flax's state-dict layout) into
    `optimizer`, a torch Adam whose one parameter group is
    ``model.parameters()`` in order."""
    adam = opt_state_np["0"]
    step = float(np.asarray(adam["count"]))
    tables = {name: (path, layout) for name, coll, path, layout in avc_leaves(model_type)
              if coll == "params"}
    state = {}
    for i, (name, _) in enumerate(model.named_parameters()):
        path, layout = tables[name]
        state[i] = {
            "step": torch.tensor(step, dtype=torch.float32),
            "exp_avg": to_torch_layout(_get(adam["mu"], path), layout),
            "exp_avg_sq": to_torch_layout(_get(adam["nu"], path), layout),
        }
    optimizer.load_state_dict({"state": state, "param_groups": optimizer.state_dict()["param_groups"]})


def block1_conv_from_jax(w_hwio, scale, shift) -> dict:
    """A 3×3 64 → 64 HWIO conv kernel and its BN scale and shift (numpy, as
    ``tools/pallas_block1_spike.py`` makes them) → the port's block-1
    operands: ``w`` (576, 64) bf16 with rows in (dy, dx, ci) order (the
    kernel's layout, which ``ops.block1_kernel`` takes), ``w_oihw`` (64, 64,
    3, 3) bf16 (the cuDNN yardstick's), ``scale`` and ``shift`` (64,) f32."""
    w = np.asarray(w_hwio, np.float32)
    if w.shape != (3, 3, 64, 64):
        raise ValueError(f"block1_conv_from_jax: need a (3, 3, 64, 64) HWIO kernel, got {w.shape}")
    return {
        "w": to_torch_layout(w.reshape(576, 64), None).to(torch.bfloat16),
        "w_oihw": to_torch_layout(w, "conv").to(torch.bfloat16),
        "scale": to_torch_layout(np.reshape(scale, 64), None),
        "shift": to_torch_layout(np.reshape(shift, 64), None),
    }


def vggish_from_jax(params_np: dict) -> dict:
    """flax VGGish params ``{layer: {"kernel", "bias"}}`` (numpy) → the state
    dict of ``models.vggish.VGGish`` (conv HWIO → OIHW, dense (in, out) →
    (out, in); fc1_1's rows stay in JAX's H·W·C order, which the module's
    flatten follows). ``models.vggish.save_vggish_npz`` writes the result
    in the npz layout both packages load."""
    from ..models.vggish import CONVS, DENSES

    sd = {}
    for group, layers, layout in (("convs", CONVS, "conv"), ("fcs", DENSES, "dense")):
        for name, *_ in layers:
            sd[f"{group}.{name}.weight"] = to_torch_layout(params_np[name]["kernel"], layout)
            sd[f"{group}.{name}.bias"] = to_torch_layout(params_np[name]["bias"], None)
    return sd


def mlp_from_jax(params_np) -> torch.nn.Module:
    """The JAX package's downstream MLP parameters, ``[{"w": (in, out),
    "b": (out,)}, ...]`` (numpy or jax arrays; the layout of its
    ``model.pkl``), → a ``classifier.mlp.MLP`` on the CPU holding them
    (dense kernels (in, out) → (out, in))."""
    from ..classifier.mlp import MLP

    ws = [np.asarray(layer["w"], np.float32) for layer in params_np]
    model = MLP(ws[0].shape[0], ws[-1].shape[1], tuple(w.shape[1] for w in ws[:-1]))
    model.load_state_dict({
        **{f"layers.{i}.weight": to_torch_layout(w, "dense") for i, w in enumerate(ws)},
        **{f"layers.{i}.bias": to_torch_layout(layer["b"], None) for i, layer in enumerate(params_np)},
    })
    return model
