"""Carry JAX/flax AVC variables into the port's modules.

Each function takes flax variables as numpy arrays, ``{"params": ...,
"batch_stats": ...}`` (the full AVC tree, or for the tower functions the
tower's own subtree), and returns a state dict:

  * ``from_jax_variables(variables, model_type)`` → the audio tower's;
  * ``vision_from_jax_variables(variables, model_type)`` → the vision tower's;
  * ``avc_from_jax_variables(variables, model_type)`` → the whole AVCModel's;
  * ``block1_conv_from_jax(w_hwio, scale, shift)`` → the block-1 probe
    kernel's operands (not a state dict).

Naming follows flax's auto-names. In a full tower ``ConvBNRelu_{i}/{Conv_0,
BatchNorm_0}`` are the blocks and ``{audio,vision}_embedding_layer`` the
embedding conv; ``BatchNorm_0`` is the input BN and ``BatchNorm_1`` the
final BN, except where the tower has no input BN (cnn_L3_orig), where the
final BN is ``BatchNorm_0``. In a tiny tower the convs are ``Conv_0``,
``Conv_1``, ``embedding_conv`` and the BNs ``BatchNorm_0..2``. Conv kernels
go from HWIO to OIHW, dense kernels from (in, out) to (out, in); BN
scale/bias/mean/var go to weight/bias/running_mean/running_var.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.registry import ModelSpec, build_model


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _conv(p: dict, prefix: str) -> dict:
    return {
        f"{prefix}.weight": _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1)),
        f"{prefix}.bias": _t(p["bias"]),
    }


def _dense(p: dict, prefix: str) -> dict:
    return {
        f"{prefix}.weight": _t(np.asarray(p["kernel"]).T),
        f"{prefix}.bias": _t(p["bias"]),
    }


def _bn(p: dict, s: dict, prefix: str) -> dict:
    return {
        f"{prefix}.weight": _t(p["scale"]),
        f"{prefix}.bias": _t(p["bias"]),
        f"{prefix}.running_mean": _t(s["mean"]),
        f"{prefix}.running_var": _t(s["var"]),
        f"{prefix}.num_batches_tracked": torch.tensor(0, dtype=torch.long),
    }


def _subtree(variables_np: dict, name: str) -> tuple[dict, dict]:
    p, s = variables_np["params"], variables_np["batch_stats"]
    if name in p:
        p, s = p[name], s[name]
    return p, s


def _tower(p: dict, s: dict, spec: ModelSpec, input_bn: bool, embedding: str) -> dict:
    sd = {}
    if spec.tiny:
        for i, conv in enumerate(("Conv_0", "Conv_1", "embedding_conv")):
            sd.update(_conv(p[conv], f"convs.{i}"))
            sd.update(_bn(p[f"BatchNorm_{i}"], s[f"BatchNorm_{i}"], f"bns.{i}"))
        return sd
    if input_bn:
        sd.update(_bn(p["BatchNorm_0"], s["BatchNorm_0"], "input_bn"))
    for i in range(7):
        bp, bs = p[f"ConvBNRelu_{i}"], s[f"ConvBNRelu_{i}"]
        sd.update(_conv(bp["Conv_0"], f"blocks.{i}.conv"))
        sd.update(_bn(bp["BatchNorm_0"], bs["BatchNorm_0"], f"blocks.{i}.bn"))
    sd.update(_conv(p[embedding], "embedding_conv"))
    final = f"BatchNorm_{int(input_bn)}"
    sd.update(_bn(p[final], s[final], "final_bn"))
    return sd


def from_jax_variables(variables_np: dict, model_type: str) -> dict:
    """flax {"params", "batch_stats"} → the audio tower's state dict."""
    spec = build_model(model_type)
    p, s = _subtree(variables_np, "audio_model")
    return _tower(p, s, spec, spec.audio_frontend != "linear", "audio_embedding_layer")


def vision_from_jax_variables(variables_np: dict, model_type: str) -> dict:
    """flax {"params", "batch_stats"} → the vision tower's state dict."""
    spec = build_model(model_type)
    p, s = _subtree(variables_np, "vision_model")
    return _tower(p, s, spec, spec.vision_input_bn, "vision_embedding_layer")


def avc_from_jax_variables(variables_np: dict, model_type: str) -> dict:
    """Full flax AVC variables → the AVCModel's state dict."""
    sd = {}
    for name, fn in (("audio_model", from_jax_variables),
                     ("vision_model", vision_from_jax_variables)):
        sd.update({f"{name}.{k}": v for k, v in fn(variables_np, model_type).items()})
    p = variables_np["params"]
    sd.update(_dense(p["merge_dense"], "merge_dense"))
    sd.update(_dense(p["output_dense"], "output_dense"))
    return sd


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
        "w": _t(w.reshape(576, 64)).to(torch.bfloat16),
        "w_oihw": _t(w.transpose(3, 2, 0, 1)).to(torch.bfloat16),
        "scale": _t(np.reshape(scale, 64)),
        "shift": _t(np.reshape(shift, 64)),
    }
