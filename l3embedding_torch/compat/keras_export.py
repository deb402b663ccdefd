"""Export AVC weights as reference-layout Keras ``.h5`` files (port of
``l3embedding_tpu/compat/keras_export.py``).

The inverse of ``compat/keras_import.py``: writes the Keras 2.x
``save_weights`` layout the reference's ``load_model`` reads (reference
l3embedding/model.py:85-128: nested ``vision_model``/``audio_model``
groups, the kapre spectrogram layer with its DFT/mel kernels, the merge
dense head) directly with h5py, so a model trained on the port can be
handed back to the 2018 Keras code or the OpenL3 export notebooks.

The kapre layer's weights are not part of a checkpoint (the DSP basis is
computed; reference audio_model.py:39-43 stores it as non-trainable conv
kernels): they are made here from ``ops/dsp_ref`` so that the file is
complete for a by_name=False Keras ``load_weights``.

``export_avc_weights(variables, model_type, path)`` takes flax-layout
numpy trees ``{"params", "batch_stats"}`` (what ``import_avc_weights`` or
``compat/to_jax.py::avc_to_jax_variables`` gives); ``export_model(model,
model_type, path)`` takes the port's AVCModel. h5py is imported inside the
writer.
"""

from __future__ import annotations

import numpy as np

from ..models.registry import build_model
from ..ops import dsp_ref
from .keras_import import input_bn_flags
from .to_jax import avc_to_jax_variables


def _f32(a):
    return np.asarray(a, dtype=np.float32)


def _tower_layer_arrays(tower_params, tower_stats, has_input_bn):
    """Ordered (kind, arrays) read from a flax-layout tree, mirroring
    keras_import._tower_targets' walk (which defines the sequence
    contract both directions rely on)."""

    def bn(p, s):
        return ("bn", [_f32(p["scale"]), _f32(p["bias"]),
                       _f32(s["mean"]), _f32(s["var"])])

    def conv(p):
        return ("conv", [_f32(p["kernel"]), _f32(p["bias"])])

    out = []
    if has_input_bn:
        out.append(bn(tower_params["BatchNorm_0"], tower_stats["BatchNorm_0"]))
    blocks = sorted(
        int(k.split("_")[1]) for k in tower_params if k.startswith("ConvBNRelu")
    )
    for i in blocks:
        sub_p = tower_params[f"ConvBNRelu_{i}"]
        sub_s = tower_stats[f"ConvBNRelu_{i}"]
        out.append(conv(sub_p["Conv_0"]))
        out.append(bn(sub_p["BatchNorm_0"], sub_s["BatchNorm_0"]))
    embed_name = next(
        (k for k in tower_params if k.endswith("_embedding_layer")), None
    )
    if embed_name:
        out.append(("embedding_conv", [_f32(tower_params[embed_name]["kernel"]),
                                       _f32(tower_params[embed_name]["bias"])]))
        final_bn = "BatchNorm_1" if has_input_bn else "BatchNorm_0"
        out.append(bn(tower_params[final_bn], tower_stats[final_bn]))
    return out


def _frontend_layer(spec):
    """(layer_name, [arrays], [suffixes]) for the audio tower's kapre DSP
    layer. All four full variants have one (Spectrogram or
    Melspectrogram, reference audio_model.py:36-43/257-259 — the 'orig'
    log-normalization is a Lambda *after* the Spectrogram layer, not a
    replacement for it); the vision tower has none."""
    if spec.audio_frontend == "mel":
        n_dft = dsp_ref.L3_N_DFT_MEL
        real, imag = dsp_ref.stft_basis(n_dft)
        n_freq = n_dft // 2 + 1
        freq2mel = dsp_ref.mel_filterbank(
            dsp_ref.L3_SAMPLE_RATE, n_dft, spec.n_mels, htk=True
        ).T
        return (
            "melspectrogram_1",
            [_f32(real.reshape(n_dft, 1, 1, n_freq)),
             _f32(imag.reshape(n_dft, 1, 1, n_freq)),
             _f32(freq2mel)],
            ["real_kernels:0", "imag_kernels:0", "freq2mel:0"],
        )
    # linear and linear_db both use the kapre Spectrogram layer
    # (reference audio_model.py:36-43, 144-151).
    n_dft = dsp_ref.L3_N_DFT_LINEAR
    real, imag = dsp_ref.stft_basis(n_dft)
    n_freq = n_dft // 2 + 1
    return (
        "spectrogram_1",
        [_f32(real.reshape(n_dft, 1, 1, n_freq)),
         _f32(imag.reshape(n_dft, 1, 1, n_freq))],
        ["real_kernels:0", "imag_kernels:0"],
    )


_BN_SFX = ["gamma:0", "beta:0", "moving_mean:0", "moving_variance:0"]
_CONV_SFX = ["kernel:0", "bias:0"]


def export_avc_weights(variables, model_type: str, h5_path: str) -> None:
    """Write {'params','batch_stats'} as a reference-layout Keras `.h5`.

    Layer naming follows Keras's creation-order counters as the 2018
    graphs produced them (vision tower built first): `conv2d_<i>` /
    `batch_normalization_<i>` global counters, with the embedding convs
    carrying their explicit names (reference audio_model.py:57,
    vision_model.py:56)."""
    import h5py

    params = variables["params"]
    stats = variables["batch_stats"]
    if not any(k.startswith("ConvBNRelu") for k in params.get("audio_model", {})):
        raise ValueError(
            f"model_type {model_type!r} has no reference Keras layout "
            "(only the four full AVC variants round-trip; tiny_L3 is a "
            "validation fixture with no 2018 checkpoint format)"
        )
    spec = build_model(model_type)
    vision_has_bn, audio_has_bn = input_bn_flags(model_type)

    conv_idx, bn_idx = 1, 1

    def tower_weight_list(tower_key, has_input_bn, frontend=None):
        """→ (wnames, arrays) for one nested-model group."""
        nonlocal conv_idx, bn_idx
        wnames, arrays = [], []

        def emit(name, arrs, suffixes):
            for sfx, arr in zip(suffixes, arrs):
                wnames.append(f"{name}/{sfx}")
                arrays.append(arr)

        if frontend is not None:
            emit(*frontend)
        for kind, arrs in _tower_layer_arrays(
            params[tower_key], stats[tower_key], has_input_bn
        ):
            if kind == "bn":
                emit(f"batch_normalization_{bn_idx}", arrs, _BN_SFX)
                bn_idx += 1
            elif kind == "conv":
                emit(f"conv2d_{conv_idx}", arrs, _CONV_SFX)
                conv_idx += 1
            else:
                # embedding conv: explicit name (reference
                # audio_model.py:57 / vision_model.py:56), but the Keras
                # conv2d_<i> counter still advances past its slot —
                # vision uses conv2d_1..7, audio starts at conv2d_9.
                emit(f"{tower_key.split('_')[0]}_embedding_layer", arrs,
                     _CONV_SFX)
                conv_idx += 1
        return wnames, arrays

    vision = tower_weight_list("vision_model", vision_has_bn)
    audio = tower_weight_list("audio_model", audio_has_bn, frontend=_frontend_layer(spec))

    dense_1 = [_f32(params["merge_dense"]["kernel"]),
               _f32(params["merge_dense"]["bias"])]
    dense_2 = [_f32(params["output_dense"]["kernel"]),
               _f32(params["output_dense"]["bias"])]

    with h5py.File(h5_path, "w") as f:
        f.attrs["layer_names"] = [
            b"input_1", b"input_2", b"vision_model", b"audio_model",
            b"concatenate_1", b"dense_1", b"dense_2",
        ]
        for lname in ("input_1", "input_2", "concatenate_1"):
            g = f.create_group(lname)
            g.attrs["weight_names"] = []
        for lname, (wnames, arrays) in (("vision_model", vision),
                                        ("audio_model", audio)):
            g = f.create_group(lname)
            g.attrs["weight_names"] = [w.encode() for w in wnames]
            for w, a in zip(wnames, arrays):
                g.create_dataset(w, data=a)
        for lname, arrs in (("dense_1", dense_1), ("dense_2", dense_2)):
            g = f.create_group(lname)
            names = [f"{lname}/kernel:0", f"{lname}/bias:0"]
            g.attrs["weight_names"] = [n.encode() for n in names]
            for n, a in zip(names, arrs):
                g.create_dataset(n, data=a)


def export_model(model, model_type: str, h5_path: str) -> None:
    """The port's AVCModel → a reference-layout Keras `.h5`."""
    export_avc_weights(avc_to_jax_variables(model, model_type), model_type, h5_path)
