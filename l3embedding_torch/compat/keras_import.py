"""Import reference Keras ``.h5`` weight files (port of
``l3embedding_tpu/compat/keras_import.py``; reference
l3embedding/train.py:316-355 saves every AVC checkpoint this way).

Reads the Keras 2.x ``save_weights`` layout directly with h5py (no
TensorFlow/Keras):

    /<layer_name>/          group per top-level layer
        attrs['weight_names'] — ordered names like
            b'vision_model/conv2d_1/kernel:0'
        <weight_name>       dataset per weight

and maps by *sequence*: per tower, optional input BN, then (conv, bn) × 7,
the embedding conv and the final BN, with kapre's spectrogram layers
(non-trainable DFT/mel kernels) skipped, since the port computes its DSP
basis. Conv kernels are (kh, kw, cin, cout) in Keras as in flax; BN weights
are gamma, beta, moving_mean, moving_variance.

``import_avc_weights`` returns flax-layout numpy trees ``{"params",
"batch_stats"}``, equal to the JAX package's import, which
``compat/from_jax.py::avc_from_jax_variables`` turns into the AVCModel's
state dict. Multi-GPU-wrapped files (the weights one level deeper under the
replicated model, reference model.py:76-77) are unwrapped. h5py is imported
inside the reader, so the module imports where h5py is missing.
"""

from __future__ import annotations

import logging
import re

import numpy as np

from ..models.registry import build_model
from .to_jax import avc_to_jax_variables

LOGGER = logging.getLogger("l3embedding_torch.compat")

_SKIP_LAYER = re.compile(r"(spectrogram|melspectrogram)", re.IGNORECASE)


def _read_keras_h5(path):
    """→ list of (layer_name, [weight names], [np arrays in weight_names order])."""
    import h5py

    layers = []
    with h5py.File(path, "r") as f:
        root = f
        layer_names = [n.decode() if isinstance(n, bytes) else n
                       for n in root.attrs["layer_names"]]
        # Multi-GPU wrapper (reference training_utils.py:21-170 saves the
        # wrapped model): the real model appears as one sub-group carrying
        # its own 'layer_names' (the tf.slice lambdas and concat layers
        # around it are weightless). Descend into it.
        if not any(n in ("vision_model", "audio_model") for n in layer_names):
            for n in layer_names:
                if (
                    n in root
                    and isinstance(root[n], h5py.Group)
                    and "layer_names" in root[n].attrs
                ):
                    root = root[n]
                    layer_names = [
                        m.decode() if isinstance(m, bytes) else m
                        for m in root.attrs["layer_names"]
                    ]
                    break
        for name in layer_names:
            grp = root[name]
            wnames = [w.decode() if isinstance(w, bytes) else w
                      for w in grp.attrs.get("weight_names", [])]
            arrays = [np.asarray(grp[w]) for w in wnames]
            layers.append((name, wnames, arrays))
    return layers


def _classify(arrays):
    """'conv'|'dense'|'bn'|'empty' from the weight-array signature."""
    if not arrays:
        return "empty"
    if len(arrays) == 4 and all(a.ndim == 1 for a in arrays):
        return "bn"
    if len(arrays) == 2 and arrays[0].ndim == 4:
        return "conv"
    if len(arrays) == 2 and arrays[0].ndim == 2:
        return "dense"
    return "other"


def _tower_targets(tower_params, tower_stats, has_input_bn):
    """Ordered (kind, assign_fn) targets matching Keras layer order."""
    targets = []

    def bn(params_bn, stats_bn):
        def assign(arrays):
            gamma, beta, mean, var = arrays
            params_bn["scale"] = gamma
            params_bn["bias"] = beta
            stats_bn["mean"] = mean
            stats_bn["var"] = var

        return ("bn", assign)

    def conv(params_conv):
        def assign(arrays):
            params_conv["kernel"] = arrays[0]
            params_conv["bias"] = arrays[1]

        return ("conv", assign)

    if has_input_bn:
        targets.append(bn(tower_params["BatchNorm_0"],
                          tower_stats["BatchNorm_0"]))

    n_blocks = sorted(
        int(k.split("_")[1]) for k in tower_params if k.startswith("ConvBNRelu")
    )
    for i in n_blocks:
        sub_p = tower_params[f"ConvBNRelu_{i}"]
        sub_s = tower_stats[f"ConvBNRelu_{i}"]
        targets.append(conv(sub_p["Conv_0"]))
        targets.append(bn(sub_p["BatchNorm_0"], sub_s["BatchNorm_0"]))

    embed_name = next(
        (k for k in tower_params if k.endswith("_embedding_layer")), None
    )
    if embed_name:
        # Name anchor: the reference names this conv explicitly
        # ('audio_embedding_layer'/'vision_embedding_layer', reference
        # audio_model.py:57, vision_model.py:56), so sequence mapping is
        # cross-checked against the Keras layer name at this position.
        kind, assign = conv(tower_params[embed_name])
        targets.append((kind, assign, "embedding_layer"))
        final_bn = "BatchNorm_1" if has_input_bn else "BatchNorm_0"
        targets.append(bn(tower_params[final_bn], tower_stats[final_bn]))
    return targets


def input_bn_flags(model_type: str) -> tuple[bool, bool]:
    """(vision tower has an input BN, audio tower has an input BN), as the
    reference's graphs build them: the vision input BN except in cnn_L3_orig,
    the audio one after a dB front end ('linear_db', 'mel'); the tiny
    towers have neither."""
    spec = build_model(model_type)
    return (not spec.tiny and spec.vision_input_bn,
            spec.audio_frontend in ("linear_db", "mel"))


def _map_tree(fn, template, tree):
    """fn(template leaf, tree leaf) over two nested dicts of one structure."""
    if isinstance(template, dict):
        if not isinstance(tree, dict) or set(tree) != set(template):
            raise ValueError("tree structure differs from the model's")
        return {k: _map_tree(fn, template[k], tree[k]) for k in template}
    return fn(template, tree)


def _copy_tree(tree):
    return {k: _copy_tree(v) for k, v in tree.items()} if isinstance(tree, dict) else tree


def import_avc_weights(h5_path: str, model_type: str):
    """Load a reference AVC weights .h5 → {'params': ..., 'batch_stats': ...}
    as flax-layout numpy trees, every tensor replaced by the Keras values
    (shape-checked against the model's)."""
    template = avc_to_jax_variables(build_model(model_type).module(), model_type)
    params = _copy_tree(template["params"])
    stats = _copy_tree(template["batch_stats"])
    vision_bn, audio_bn = input_bn_flags(model_type)

    layers = _read_keras_h5(h5_path)

    # Split the flat layer list into the towers + merge head. Keras names
    # nested models 'vision_model'/'audio_model' (reference
    # vision_model.py:100, audio_model.py:113).
    head_dense = []
    for name, wnames, arrays in layers:
        kind = _classify(arrays)
        if kind == "empty":
            continue
        if name in ("vision_model", "audio_model"):
            # Nested model: its arrays are all inner weights in creation
            # order; regroup them by inner-layer prefix.
            groups = {}
            order = []
            for wname, arr in zip(wnames, arrays):
                inner = "/".join(wname.split("/")[:-1])
                if inner not in groups:
                    groups[inner] = []
                    order.append(inner)
                groups[inner].append(arr)

            tower_key = name
            has_input_bn = vision_bn if tower_key == "vision_model" else audio_bn
            targets = _tower_targets(
                params[tower_key], stats[tower_key], has_input_bn
            )
            ti = 0
            for inner in order:
                arrays_i = groups[inner]
                kind_i = _classify(arrays_i)
                if kind_i in ("other", "empty") or _SKIP_LAYER.search(inner):
                    continue
                if ti >= len(targets):
                    raise ValueError(
                        f"more Keras layers than targets in {tower_key} "
                        f"at {inner}"
                    )
                want_kind, assign, *anchor = targets[ti]
                if want_kind != kind_i:
                    raise ValueError(
                        f"{tower_key}: expected {want_kind} at position "
                        f"{ti}, got {kind_i} ({inner})"
                    )
                # Name-anchored cross-check: the embedding conv must line
                # up with the Keras layer actually named *_embedding_layer
                # (guards against same-shaped layers slipping a position).
                if anchor and anchor[0] not in inner:
                    raise ValueError(
                        f"{tower_key}: expected a layer named like "
                        f"'*{anchor[0]}*' at position {ti}, got {inner!r} "
                        "— sequence mapping is misaligned"
                    )
                if not anchor and "embedding_layer" in inner:
                    raise ValueError(
                        f"{tower_key}: Keras layer {inner!r} (the embedding "
                        f"conv) arrived at position {ti}, which maps to a "
                        "different target — sequence mapping is misaligned"
                    )
                assign(arrays_i)
                ti += 1
            if ti != len(targets):
                raise ValueError(
                    f"{tower_key}: assigned {ti}/{len(targets)} layers"
                )
        elif kind == "dense":
            head_dense.append(arrays)
        elif _SKIP_LAYER.search(name):
            continue

    if len(head_dense) != 2:
        raise ValueError(
            f"expected 2 dense head layers, found {len(head_dense)}"
        )
    params["merge_dense"]["kernel"] = head_dense[0][0]
    params["merge_dense"]["bias"] = head_dense[0][1]
    params["output_dense"]["kernel"] = head_dense[1][0]
    params["output_dense"]["bias"] = head_dense[1][1]

    # Shape check everything against the template.
    def check(a, b):
        if a.shape != np.asarray(b).shape:
            raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
        return np.asarray(b, dtype=np.float32)

    params = _map_tree(check, template["params"], params)
    stats = _map_tree(check, template["batch_stats"], stats)
    return {"params": params, "batch_stats": stats}
