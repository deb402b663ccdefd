"""Tensor parallelism over the mesh's ``model`` axis (port of
``l3embedding_tpu/parallel/tp.py``).

JAX's version is layout-only: ``tp_shard_state`` places the widest
parameters, and their Adam moments, on the ``model`` axis, and XLA inserts
the collectives. In torch nothing is layout-only. ``tp_shard_state``
replaces the split parameters and running statistics of a replicated state
by this rank's slices, rebuilds Adam over them, and marks the split layers
(``towers.ModelSplit``), which then run their collectives over the mesh's
model group in the forward and the backward pass (the Megatron pattern;
``towers._conv``, ``avc._dense``):

  * the block-4 conv (``blocks.6``, 256 → 512 in both full towers) is
    column-parallel: its output channels are split, with its bias and its
    BatchNorm, whose moments are taken over the data group alone; its
    input's gradient is summed over the model group;
  * the full towers' embedding conv (512 → 512) is row-parallel: its input
    channels are split, the partial sums summed over the model group in
    f32, the replicated bias added once;
  * the tiny towers' embedding conv (``convs.2``) is column-parallel and
    gathers its 10 channels back before its (replicated) BatchNorm;
  * ``merge_dense`` (1024 → 128) is row-parallel over its input rows.

Rank m of the model group keeps ``[m·C/M, (m+1)·C/M)`` of each split
dimension, the shard that JAX's ``NamedSharding`` puts on model index m.
The rules are JAX's (a flax path suffix → the axis of its spec that
``model`` splits); ``split_leaves`` maps them to the port's names and dims
through ``compat/from_jax.avc_leaves``. Checkpoints stay independent of the
topology: ``training/checkpoints.state_tree`` gathers the split leaves
(``gather_tree``) and ``load_state_tree`` slices them (``slice_tree``).
With model_axis=1 nothing is split: pure data parallelism.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from ..compat.from_jax import avc_from_jax_variables, avc_leaves, bn_fed_biases
from ..models.towers import ModelSplit
from .distributed import comm_device
from .mesh import ProcessMesh

# (flax path suffix, the axis of the leaf that 'model' splits), as
# l3embedding_tpu/parallel/tp.py's _RULES (conv kernels HWIO, dense (in, out)).
_RULES = (
    (("ConvBNRelu_6", "Conv_0", "kernel"), 3),
    (("ConvBNRelu_6", "Conv_0", "bias"), 0),
    (("ConvBNRelu_6", "BatchNorm_0", "scale"), 0),
    (("ConvBNRelu_6", "BatchNorm_0", "bias"), 0),
    (("ConvBNRelu_6", "BatchNorm_0", "mean"), 0),
    (("ConvBNRelu_6", "BatchNorm_0", "var"), 0),
    (("audio_embedding_layer", "kernel"), 2),
    (("vision_embedding_layer", "kernel"), 2),
    (("embedding_conv", "kernel"), 3),
    (("embedding_conv", "bias"), 0),
    (("merge_dense", "kernel"), 0),
)
# A flax axis → the torch dim, by layout (HWIO → OIHW, (in, out) → (out, in)).
_TORCH_DIM = {"conv": (2, 3, 1, 0), "dense": (1, 0), None: (0,)}


def split_axis(path: tuple) -> int | None:
    """The axis the rules split a flax leaf on (its path's suffix), or None:
    replicated."""
    for suffix, axis in _RULES:
        if tuple(path[-len(suffix):]) == suffix:
            return axis
    return None


def split_leaves(model_type: str) -> dict:
    """{torch name: torch dim} of every parameter and running statistic of
    the AVC model that the rules split."""
    out = {}
    for name, _, path, layout in avc_leaves(model_type):
        axis = split_axis(path)
        if axis is not None:
            out[name] = _TORCH_DIM[layout][axis]
    return out


def tp_mesh(model: nn.Module) -> ProcessMesh | None:
    """The mesh a model was split over by ``tp_shard_state``, or None."""
    return vars(model).get("tp_mesh")


def _block(n: int, mesh: ProcessMesh, what) -> slice:
    if n % mesh.model:
        raise ValueError(f"{what}: {n} not divisible by model_axis={mesh.model}")
    k = n // mesh.model
    return slice(mesh.model_index * k, (mesh.model_index + 1) * k)


def _map_split(tree, fn, path=()):
    """`tree` with fn(leaf, axis, path) in place of every leaf the rules
    split; the other leaves as they are."""
    if isinstance(tree, dict):
        return {k: _map_split(v, fn, path + (k,)) for k, v in tree.items()}
    axis = split_axis(path)
    return tree if axis is None else fn(tree, axis, path)


def slice_tree(tree: dict, mesh: ProcessMesh | None) -> dict:
    """A full flax-layout tree (``checkpoints.state_tree``'s, or a part of
    it) → this rank's slices of the split leaves; the tree as it is without
    a model axis."""
    if mesh is None or mesh.model == 1:
        return tree

    def take(a, axis, path):
        a = np.asarray(a)
        index = [slice(None)] * a.ndim
        index[axis] = _block(a.shape[axis], mesh, "/".join(path))
        return np.ascontiguousarray(a[tuple(index)])

    return _map_split(tree, take)


def _all_gather(t: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    local = t.detach().contiguous().to(comm_device(group))
    parts = [torch.empty_like(local) for _ in range(size)]
    dist.all_gather(parts, local, group=group)
    return torch.cat(parts, dim)


def gather_tree(tree: dict, mesh: ProcessMesh | None) -> dict:
    """The inverse of ``slice_tree``: every split leaf of a tree of this
    rank's slices gathered over the model group (every rank of it takes
    part); the tree as it is without a model axis."""
    if mesh is None or mesh.model == 1:
        return tree
    return _map_split(tree, lambda a, axis, _: _all_gather(
        torch.from_numpy(np.ascontiguousarray(a)), axis, mesh.model_group, mesh.model).cpu().numpy())


def gather_tensors(tensors: dict, model_type: str, mesh: ProcessMesh | None) -> dict:
    """{torch name: tensor} of this rank (parameters, their gradients) →
    the whole tensors, the split ones gathered over the model group along
    their torch dim (every rank of it takes part), on the CPU."""
    dims = split_leaves(model_type) if mesh is not None and mesh.model > 1 else {}
    return {n: (_all_gather(t, dims[n], mesh.model_group, mesh.model) if n in dims else t.detach()).cpu()
            for n, t in tensors.items()}


def tp_shard_state(state, mesh: ProcessMesh):
    """Split a train state over the mesh's model axis in place, by JAX's
    rules: each split parameter and running statistic becomes this rank's
    slice, Adam is rebuilt over the new parameters with its moments (and
    step) sliced alike, and the split layers are marked to run their
    collectives. Everything else stays replicated; the state must be the
    same on every rank first (``replicate``). → state."""
    from ..training import checkpoints
    from ..training.state import make_optimizer

    if mesh.model == 1:
        return state
    if tp_mesh(state.model) is not None:
        raise ValueError("the state is split over a model axis already")
    model, model_type = state.model, state.model_type
    tree = checkpoints.state_tree(state)
    device = next(model.parameters()).device
    sliced = avc_from_jax_variables(slice_tree(tree, mesh), model_type)
    dims = split_leaves(model_type)
    fed = {conv.rsplit(".", 1)[0]: bn.rsplit(".", 1)[0] for conv, bn in bn_fed_biases(model_type).items()}
    for name, dim in dims.items():
        prefix, attr = name.rsplit(".", 1)
        module = model.get_submodule(prefix)
        t = sliced[name].to(device)
        setattr(module, attr, nn.Parameter(t) if attr in module._parameters else t)
        if attr == "weight" and isinstance(module, (nn.Conv2d, nn.Linear)):
            if dim == 1:
                kind = "row"
            else:  # a column conv: its channels stay split through a split BN
                kind = "column" if f"{fed[prefix]}.weight" in dims else "gather"
            module.model_split = ModelSplit(kind, mesh.model_group, mesh.model_index)
    model.tp_mesh = mesh
    state.optimizer = make_optimizer(model, state.optimizer.param_groups[0]["lr"])
    return checkpoints.load_state_tree(tree, state)
