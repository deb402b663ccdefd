"""What the drivers need of the program beyond its entry points: where the
reference's leaves live in the program's modules."""

from __future__ import annotations

import torch

_BN = {"scale": "weight", "offset": "bias", "mean": "running_mean", "var": "running_var"}
_CONV = {"kernel": "weight", "bias": "bias"}
AVC_TOWERS = {"vision": "vision_model.", "audio": "audio_model."}


def port_name(name: str, towers: dict = AVC_TOWERS) -> str:
    """A reference leaf name ("audio.conv3.kernel") → the program's
    state-dict name ("audio_model.blocks.3.conv.weight")."""
    part, layer, leaf = name.split(".")
    if part == "head":
        return {"fc1": "merge_dense", "fc2": "output_dense"}[layer] + "." + _CONV[leaf]
    if layer == "bn_in":
        mod, table = "input_bn", _BN
    elif layer == "bn_out":
        mod, table = "final_bn", _BN
    elif layer == "emb":
        mod, table = "embedding_conv", _CONV
    elif layer.startswith("conv"):
        mod, table = f"blocks.{layer[4:]}.conv", _CONV
    else:
        mod, table = f"blocks.{layer[2:]}.bn", _BN
    return towers[part] + mod + "." + table[leaf]


def load(module: torch.nn.Module, params: dict, towers: dict = AVC_TOWERS) -> None:
    """Copy the harness's leaves into the program's module in place; every
    parameter and statistic of the module must be given one."""
    sd = module.state_dict()
    done = set()
    with torch.no_grad():
        for name, value in params.items():
            target = port_name(name, towers)
            sd[target].copy_(value)
            done.add(target)
    missing = [k for k in sd if k not in done and not k.endswith("num_batches_tracked")]
    if missing:
        raise ValueError(f"the harness gave no value for {missing[:5]}")


def read(module: torch.nn.Module, names, towers: dict = AVC_TOWERS, device="cpu") -> dict:
    """The program's current leaves under the reference's names, copied to
    `device` as float32."""
    sd = module.state_dict()
    return {n: sd[port_name(n, towers)].detach().float().to(device, copy=True) for n in names}
