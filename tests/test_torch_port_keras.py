"""The port's Keras ``.h5`` compat layer against the JAX package's
(``l3embedding_torch/compat/keras_{import,export}.py`` against
``l3embedding_tpu/compat/keras_{import,export}.py``): the cases of
``tests/test_keras_import.py`` on files from the JAX package's
``keras_synth.synthesize_keras_h5``, each held against JAX's result — bit
for bit for the imported trees and the exported files, the same message for
every refusal — and the ``.h5`` routes of ``load_model`` and
``ImageEmbeddingModel`` against their ``.ckpt`` routes."""

import h5py
import numpy as np
import pytest
import torch

from l3embedding_tpu.compat import keras_export as jax_export
from l3embedding_tpu.compat import keras_import as jax_import
from l3embedding_tpu.compat.keras_synth import synthesize_keras_h5
from l3embedding_tpu.ops import dsp_ref as jax_dsp_ref
from l3embedding_tpu.training.checkpoints import save_variables as jax_save_variables
from l3embedding_torch import api
from l3embedding_torch.compat import keras_export, keras_import
from l3embedding_torch.compat.from_jax import avc_from_jax_variables
from l3embedding_torch.compat.to_jax import avc_to_jax_variables
from l3embedding_torch.embed import extract
from l3embedding_torch.models import loading
from l3embedding_torch.models.registry import build_model
from torch_port_threads import one_torch_thread  # noqa: F401

MS2 = "cnn_L3_melspec2"


def flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, prefix + (k,)))
        return out
    return {prefix: np.asarray(tree)}


def assert_trees_identical(a, b):
    fa, fb = flat(a), flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
        assert fa[k].tobytes() == fb[k].tobytes(), k


def port_variables(model_type, seed):
    """Seeded random AVC variables in flax's layout, from the port's model."""
    model = build_model(model_type).module()
    model.reset_parameters(torch.Generator().manual_seed(seed))
    for name, buf in model.named_buffers():
        if name.endswith("running_var"):  # non-trivial statistics
            buf.uniform_(0.5, 2.0, generator=torch.Generator().manual_seed(seed + 1))
    return avc_to_jax_variables(model, model_type)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """A reference-layout melspec2 .h5 and its ground-truth arrays."""
    path = str(tmp_path_factory.mktemp("keras") / "model_latest.h5")
    truth = synthesize_keras_h5(path, np.random.RandomState(7))
    return path, truth


def test_import_melspec2_equals_jax(synth):
    path, truth = synth
    ours = keras_import.import_avc_weights(path, MS2)
    assert_trees_identical(ours, jax_import.import_avc_weights(path, MS2))
    params, stats = ours["params"], ours["batch_stats"]
    np.testing.assert_array_equal(params["vision_model"]["BatchNorm_0"]["scale"], truth["vision"][0][1][0])
    np.testing.assert_array_equal(stats["audio_model"]["BatchNorm_0"]["var"], truth["audio"][1][1][3])
    np.testing.assert_array_equal(params["audio_model"]["audio_embedding_layer"]["kernel"], truth["audio"][-2][1][0])
    np.testing.assert_array_equal(stats["audio_model"]["BatchNorm_1"]["mean"], truth["audio"][-1][1][2])
    np.testing.assert_array_equal(params["merge_dense"]["kernel"], truth["dense_1"][0])
    np.testing.assert_array_equal(params["output_dense"]["bias"], truth["dense_2"][1])
    # The port's model takes the tree as it is.
    sd = avc_from_jax_variables(ours, MS2)
    build_model(MS2).module().load_state_dict(sd)


def _error(fn, *args):
    with pytest.raises(ValueError) as info:
        fn(*args)
    return str(info.value)


def test_import_shape_mismatch_raises_as_jax(synth):
    """tiny_L3 against a melspec2 file: the same ValueError as JAX's."""
    path, _ = synth
    ours = _error(keras_import.import_avc_weights, path, "tiny_L3")
    assert ours == _error(jax_import.import_avc_weights, path, "tiny_L3")


def test_import_multigpu_wrapped_equals_jax(synth, tmp_path):
    """The whole model nested one level deeper behind weightless
    slice/concat layers (reference model.py:76-77)."""
    inner_path, truth = synth
    wrapped_path = str(tmp_path / "wrapped.h5")
    with h5py.File(inner_path, "r") as src, h5py.File(wrapped_path, "w") as dst:
        dst.attrs["layer_names"] = [b"input_1", b"input_2", b"lambda_1", b"lambda_2",
                                    b"cnn_L3_melspec2", b"concatenate_2"]
        for name in ("input_1", "input_2", "lambda_1", "lambda_2", "concatenate_2"):
            dst.create_group(name).attrs["weight_names"] = []
        src.copy(src["/"], dst, name="cnn_L3_melspec2")
        dst["cnn_L3_melspec2"].attrs["layer_names"] = src.attrs["layer_names"]
    ours = keras_import.import_avc_weights(wrapped_path, MS2)
    assert_trees_identical(ours, jax_import.import_avc_weights(wrapped_path, MS2))
    assert_trees_identical(ours, keras_import.import_avc_weights(inner_path, MS2))
    np.testing.assert_array_equal(ours["params"]["merge_dense"]["kernel"], truth["dense_1"][0])


def test_import_misaligned_embedding_layer_raises_as_jax(synth, tmp_path):
    """The last plain vision conv and the embedding conv swapped in
    weight_names (both 3×3×512×512): the name anchor refuses it, with JAX's
    message."""
    path = str(tmp_path / "swapped.h5")
    with h5py.File(synth[0], "r") as src, h5py.File(path, "w") as dst:
        for name in src:
            src.copy(src[name], dst, name=name)
        dst.attrs["layer_names"] = src.attrs["layer_names"]
    with h5py.File(path, "r+") as f:
        g = f["vision_model"]
        wnames = [w.decode() if isinstance(w, bytes) else w for w in g.attrs["weight_names"]]
        emb = [i for i, w in enumerate(wnames) if w.startswith("vision_embedding_layer/")]
        plain = [i for i, w in enumerate(wnames) if w.startswith("conv2d_7/")]
        assert len(emb) == len(plain) == 2
        for a, b in zip(plain, emb):
            wnames[a], wnames[b] = wnames[b], wnames[a]
        g.attrs["weight_names"] = [w.encode() for w in wnames]
    ours = _error(keras_import.import_avc_weights, path, MS2)
    assert "misaligned" in ours
    assert ours == _error(jax_import.import_avc_weights, path, MS2)


@pytest.mark.parametrize("model_type", [MS2, "cnn_L3_orig"])
def test_export_roundtrips_through_both_packages(tmp_path, model_type):
    """The port's export reads back through JAX's import, JAX's export
    through the port's, each equal to the variables bit for bit (the mel
    front end with input BNs, and the linear one without)."""
    variables = port_variables(model_type, seed=3)
    ours, theirs = str(tmp_path / "port.h5"), str(tmp_path / "jax.h5")
    keras_export.export_avc_weights(variables, model_type, ours)
    jax_export.export_avc_weights(variables, model_type, theirs)
    assert_trees_identical(jax_import.import_avc_weights(ours, model_type), variables)
    assert_trees_identical(keras_import.import_avc_weights(theirs, model_type), variables)


def _h5_items(path):
    """{name: (kind, attrs, dtype, shape, bytes)} of every object in a file."""
    out = {}
    with h5py.File(path, "r") as f:
        def attrs(obj):
            """name → (HDF5 type class, size, variable-length, shape, values)."""
            out = {}
            for k, v in obj.attrs.items():
                aid = obj.attrs.get_id(k)
                tid = aid.get_type()
                vlen = tid.is_variable_str() if tid.get_class() == h5py.h5t.STRING else None
                out[k] = (tid.get_class(), tid.get_size(), vlen, aid.shape, np.asarray(v).tolist())
            return out

        out["/"] = ("group", attrs(f), None, None, None)

        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                a = obj[()]
                out[name] = ("dataset", attrs(obj), a.dtype.str, a.shape, a.tobytes())
            else:
                out[name] = ("group", attrs(obj), None, None, None)

        f.visititems(visit)
    return out


def test_export_structure_equals_jax_byte_for_byte(synth, tmp_path):
    """From one imported tree, the port's file and JAX's have the same
    groups, attributes (values, dtypes, shapes — the byte-string lists and
    the empty weight_names) and datasets, byte for byte, the kapre kernels
    included; and the reference file's layer_names / weight_names."""
    variables = keras_import.import_avc_weights(synth[0], MS2)
    ours, theirs = str(tmp_path / "port.h5"), str(tmp_path / "jax.h5")
    keras_export.export_avc_weights(variables, MS2, ours)
    jax_export.export_avc_weights(variables, MS2, theirs)
    items_o, items_j = _h5_items(ours), _h5_items(theirs)
    assert sorted(items_o) == sorted(items_j)
    for name in items_j:
        assert items_o[name] == items_j[name], name
    with h5py.File(synth[0], "r") as fr, h5py.File(ours, "r") as fo:
        assert list(fr.attrs["layer_names"]) == list(fo.attrs["layer_names"])
        for lname in fr.attrs["layer_names"]:
            lname = lname.decode() if isinstance(lname, bytes) else lname
            assert list(fr[lname].attrs["weight_names"]) == list(fo[lname].attrs["weight_names"]), lname


def test_export_kapre_kernels_are_the_true_basis(tmp_path):
    """export_model of a port melspec2 model writes kapre's kernels as the
    windowed DFT and HTK mel matrices of the JAX package's dsp_ref."""
    model = build_model(MS2).module()
    model.reset_parameters(torch.Generator().manual_seed(1))
    out = str(tmp_path / "out.h5")
    keras_export.export_model(model, MS2, out)
    real, imag = jax_dsp_ref.stft_basis(2048)
    mel = jax_dsp_ref.mel_filterbank(48000, 2048, 256, htk=True).T
    with h5py.File(out, "r") as f:
        g = f["audio_model"]
        np.testing.assert_allclose(np.asarray(g["melspectrogram_1/real_kernels:0"]).reshape(2048, 1025), real, atol=1e-6)
        np.testing.assert_allclose(np.asarray(g["melspectrogram_1/imag_kernels:0"]).reshape(2048, 1025), imag, atol=1e-6)
        np.testing.assert_allclose(np.asarray(g["melspectrogram_1/freq2mel:0"]), mel, atol=1e-6)
    # The file reads back into the same model.
    back = avc_from_jax_variables(keras_import.import_avc_weights(out, MS2), MS2)
    for k, v in model.state_dict().items():
        assert torch.equal(v, back[k]), k


def test_export_rejects_tiny_as_jax(tmp_path):
    variables = {"params": {"audio_model": {"Conv_0": {}}}, "batch_stats": {"audio_model": {}}}
    ours = _error(keras_export.export_avc_weights, variables, "tiny_L3", str(tmp_path / "a.h5"))
    assert "tiny_L3" in ours
    assert ours == _error(jax_export.export_avc_weights, variables, "tiny_L3", str(tmp_path / "b.h5"))


@pytest.fixture(scope="module")
def h5_and_ckpt(synth, tmp_path_factory):
    """The synthesized .h5 and a .ckpt of the same weights written by JAX."""
    path, _ = synth
    v = jax_import.import_avc_weights(path, MS2)
    ckpt = str(tmp_path_factory.mktemp("ckpt") / "model.ckpt")
    jax_save_variables(ckpt, v["params"], v["batch_stats"])
    return path, ckpt


def test_load_model_h5_equals_ckpt(h5_and_ckpt):
    """load_model on the .h5 gives the .ckpt's model, tensor for tensor, and
    its logits on one pair."""
    h5, ckpt = h5_and_ckpt
    from_h5, state = loading.load_model(h5, MS2, device="cpu")
    from_ckpt, _ = loading.load_model(ckpt, MS2, device="cpu")
    assert not from_h5.training and set(state) == set(from_ckpt.state_dict())
    for k, v in from_ckpt.state_dict().items():
        assert torch.equal(v, state[k]), k
    rng = np.random.RandomState(2)
    video = torch.from_numpy((rng.rand(1, 224, 224, 3) * 2 - 1).astype(np.float32))
    audio = torch.from_numpy((rng.randn(1, 1, 48000) * 0.1).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(from_h5(video, audio), from_ckpt(video, audio))


def test_image_embedding_model_h5_equals_ckpt(h5_and_ckpt, monkeypatch):
    h5, ckpt = h5_and_ckpt
    monkeypatch.setattr(extract, "BUCKETS", (1,))  # one image a forward on the CPU
    frames = np.random.RandomState(4).randint(0, 256, (1, 224, 224, 3), dtype=np.uint8)
    rows = api.ImageEmbeddingModel(h5, model_type=MS2, device="cpu").embed_frames(frames)
    want = api.ImageEmbeddingModel(ckpt, model_type=MS2, device="cpu").embed_frames(frames)
    assert rows.shape == (1, 8192) and np.isfinite(rows).all()
    np.testing.assert_array_equal(rows, want)
