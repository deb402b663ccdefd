"""The PyTorch port's linear and tiny audio towers, vision towers and AVC
forward against the JAX package, for all five model types.

Each model type's flax variables are drawn once (module scope) from a
seeded numpy generator into the tree shape of the JAX model: He-scaled
kernels, nonzero biases, BN statistics away from the identity. The same
variables are carried into the port with ``compat.from_jax`` (or through
a ``.ckpt`` file), and the same numpy audio and images go through both
packages on the CPU, at batch 2.
"""

import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from l3embedding_tpu import api as jax_api
from l3embedding_tpu.models import MODELS as JAX_MODELS
from l3embedding_tpu.models import audio_embedding_fn as jax_audio_embedding_fn
from l3embedding_tpu.models import build_model as jax_build_model
from l3embedding_tpu.models import vision_embedding_fn as jax_vision_embedding_fn
from l3embedding_tpu.models.avc import predict_proba as jax_predict_proba
from l3embedding_tpu.training.checkpoints import save_variables
from l3embedding_torch import api as torch_api
from l3embedding_torch.compat.from_jax import (
    avc_from_jax_variables,
    from_jax_variables,
    vision_from_jax_variables,
)
from l3embedding_torch.models.embedding import audio_embedding_fn, vision_embedding_fn
from l3embedding_torch.models.registry import build_model
from l3embedding_torch.training.checkpoints import load_variables
from torch_port_threads import one_torch_thread  # noqa: F401


def _leaf(rng, path, shape):
    name = getattr(path[-1], "key", "")
    if name == "kernel":  # conv HWIO or dense (in, out): He-normal scale
        return rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[:-1]))
    if name == "scale":
        return 1.0 + 0.1 * rng.randn(*shape)
    if name == "var":
        return 1.0 + 0.3 * np.abs(rng.randn(*shape))
    return 0.05 * rng.randn(*shape)  # biases and means


@pytest.fixture(scope="module")
def variables():
    """model_type → numpy flax variables {"params", "batch_stats"}, built
    once per type."""
    cache = {}

    def get(model_type):
        if model_type not in cache:
            model = jax_build_model(model_type).module()
            shapes = jax.eval_shape(
                lambda: model.init(
                    jax.random.PRNGKey(0),
                    np.zeros((1, 224, 224, 3), np.float32),
                    np.zeros((1, 1, 48000), np.float32),
                    train=False,
                )
            )
            rng = np.random.RandomState(sum(map(ord, model_type)))
            cache[model_type] = {
                k: jax.tree_util.tree_map_with_path(
                    lambda p, s: _leaf(rng, p, s.shape).astype(np.float32), shapes[k]
                )
                for k in ("params", "batch_stats")
            }
        return cache[model_type]

    return get


@pytest.fixture(scope="module")
def audio():
    """Two 1 s clips; the second holds 0.4 s of digital silence, which the
    linear front end's log norm maps to log(1e-12)/5."""
    a = (np.random.RandomState(3).randn(2, 1, 48000) * 0.2).astype(np.float32)
    a[1, 0, 10000:30000] = 0.0
    return a


@pytest.fixture(scope="module")
def video():
    return np.random.RandomState(4).uniform(-1, 1, (2, 224, 224, 3)).astype(np.float32)


def _row_cos(a, b):
    return [(u @ v) / (np.linalg.norm(u) * np.linalg.norm(v) + 1e-30) for u, v in zip(a, b)]


def _close_f32(ours, theirs):
    """The f32 gate: per-row cosine >= 0.99999 and max |Δ| <= 1e-3·max|ref|."""
    assert ours.shape == theirs.shape
    assert min(_row_cos(ours, theirs)) >= 0.99999
    assert np.abs(ours - theirs).max() <= 1e-3 * np.abs(theirs).max()


def _audio_fn(variables, model_type, pooling, dtype=torch.float32):
    fn = audio_embedding_fn(model_type, pooling, compute_dtype=dtype)
    fn.tower.load_state_dict(from_jax_variables(variables(model_type), model_type))
    return fn.eval()


def _avc(variables, model_type, dtype=torch.float32):
    model = build_model(model_type).module(dtype)
    model.load_state_dict(avc_from_jax_variables(variables(model_type), model_type))
    return model.eval()


LINEAR = ["cnn_L3_orig", "cnn_L3_kapredbinputbn"]


@pytest.mark.parametrize("pooling,dim", [("short", 512), ("original", 6144)])
@pytest.mark.parametrize("model_type", LINEAR)
def test_linear_audio_embedding_matches_jax_f32(variables, audio, model_type, pooling, dim):
    """f32: per-row cosine >= 0.99999 and max |Δ| <= 1e-3 · max|emb|."""
    theirs = np.asarray(jax_audio_embedding_fn(model_type, pooling)(variables(model_type), audio))
    ours = _audio_fn(variables, model_type, pooling)(torch.from_numpy(audio)).numpy()
    assert ours.shape == (2, dim)
    _close_f32(ours, theirs)


@pytest.mark.parametrize("pooling,dim", [("short", 512), ("original", 6144)])
@pytest.mark.parametrize("model_type", LINEAR)
def test_linear_audio_embedding_matches_jax_bf16(variables, audio, model_type, pooling, dim):
    """bf16 compute in both (JAX compute_dtype=bfloat16, whose front end is
    spectrogram_bf16): cosine >= 0.999, the BASELINE parity gate."""
    theirs = np.asarray(
        jax_audio_embedding_fn(model_type, pooling, compute_dtype=jnp.bfloat16)(
            variables(model_type), audio
        )
    )
    ours = _audio_fn(variables, model_type, pooling, torch.bfloat16)(torch.from_numpy(audio)).numpy()
    assert ours.shape == theirs.shape == (2, dim)
    assert min(_row_cos(ours, theirs)) >= 0.999


def test_linear_tower_output_and_zero_rows(variables, audio):
    """cnn_L3_orig's tower output (final BN is flax's BatchNorm_0: no input
    BN) at the f32 gate; an all-zero window (a bucket's padding row) stays
    finite through the log norm."""
    mt = "cnn_L3_orig"
    tower = jax_build_model(mt).module().audio_model
    sub = {k: variables(mt)[k]["audio_model"] for k in ("params", "batch_stats")}
    theirs = np.asarray(tower.apply(sub, audio, train=False))
    fn = _audio_fn(variables, mt, "short")
    ours = fn.tower(torch.from_numpy(audio)).detach().numpy()
    assert ours.shape == (2, 512)
    _close_f32(ours, theirs)
    zero = fn(torch.zeros(2, 1, 48000)).numpy()
    assert np.isfinite(zero).all()


def test_tiny_embedding_and_tower_match_jax(variables, audio):
    """tiny_L3: the 350-d embedding (the last pooled 7×5×10 map, flattened
    NHWC, for both pooling names) and the tower's output, f32 even when
    bf16 is asked for (the JAX tiny_L3 ignores compute_dtype)."""
    mt = "tiny_L3"
    v = variables(mt)
    for pooling in ("short", "original"):
        theirs = np.asarray(jax_audio_embedding_fn(mt, pooling)(v, audio))
        ours = _audio_fn(variables, mt, pooling)(torch.from_numpy(audio)).numpy()
        assert ours.shape == (2, 350)
        _close_f32(ours, theirs)
    fast = _audio_fn(variables, mt, "short", torch.bfloat16)
    assert fast.tower.dtype == torch.float32
    sub = {k: v[k]["audio_model"] for k in ("params", "batch_stats")}
    theirs = np.asarray(jax_build_model(mt).module().audio_model.apply(sub, audio, train=False))
    _close_f32(fast.tower(torch.from_numpy(audio)).detach().numpy(), theirs)


@pytest.mark.parametrize("model_type", ["cnn_L3_orig", "cnn_L3_melspec2"])
def test_vision_embedding_matches_jax(variables, video, model_type):
    """The 8192-d vision embedding (SAME (7,7) pool over the raw
    vision_embedding_layer output), f32, without (cnn_L3_orig) and with an
    input BN."""
    theirs = np.asarray(jax_vision_embedding_fn(model_type)(variables(model_type), video))
    fn = vision_embedding_fn(model_type)
    fn.tower.load_state_dict(vision_from_jax_variables(variables(model_type), model_type))
    ours = fn.eval()(torch.from_numpy(video)).numpy()
    assert ours.shape == (2, 8192)
    _close_f32(ours, theirs)


@pytest.mark.parametrize("model_type", ["cnn_L3_orig", "cnn_L3_melspec2", "tiny_L3"])
def test_avc_logits_match_jax(variables, video, audio, model_type):
    """The AVC forward (vision first in the concat, merge_dense → ReLU →
    output_dense) in f32: logits within 1e-3 · max|logit| of model.apply,
    probabilities within 1e-4 of JAX's predict_proba."""
    model = jax_build_model(model_type).module()
    v = variables(model_type)
    theirs = np.asarray(model.apply(v, video, audio, train=False))
    ours_model = _avc(variables, model_type)
    x_v, x_a = torch.from_numpy(video), torch.from_numpy(audio)
    with torch.no_grad():
        ours = ours_model(x_v, x_a).numpy()
    assert ours.shape == (2, 2) and ours.dtype == np.float32
    assert np.abs(ours - theirs).max() <= 1e-3 * np.abs(theirs).max()
    p_theirs = np.asarray(jax_predict_proba(model, v, video, audio))
    p_ours = ours_model.predict_proba(x_v, x_a).numpy()
    np.testing.assert_allclose(p_ours, p_theirs, rtol=0, atol=1e-4)
    np.testing.assert_allclose(p_ours.sum(-1), 1.0, rtol=1e-6)


def test_avc_logits_match_jax_bf16(variables, video, audio):
    """bf16 compute (f32 params, f32 logits) in both for a full type:
    cosine >= 0.999 over the batch's logits."""
    mt = "cnn_L3_kapredbinputbn"
    theirs = np.asarray(
        jax_build_model(mt).module(compute_dtype=jnp.bfloat16).apply(
            variables(mt), video, audio, train=False
        )
    )
    with torch.no_grad():
        ours = _avc(variables, mt, torch.bfloat16)(torch.from_numpy(video), torch.from_numpy(audio))
    assert ours.dtype == torch.float32
    assert _row_cos(ours.numpy().reshape(1, -1), theirs.reshape(1, -1))[0] >= 0.999


@pytest.mark.parametrize("model_type", sorted(JAX_MODELS))
def test_from_jax_round_trip_through_ckpt(variables, model_type, tmp_path):
    """Every type: variables saved by the JAX package as a .ckpt, read back
    flax-free, fill every key of the AVC, audio-tower and vision-tower state
    dicts (strict loads), with conv kernels HWIO → OIHW and dense kernels
    transposed."""
    v = variables(model_type)
    path = str(tmp_path / "model.ckpt")
    save_variables(path, v["params"], v["batch_stats"])
    loaded = load_variables(path)
    spec = build_model(model_type)

    model = spec.module()
    sd = avc_from_jax_variables(loaded, model_type)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    dense = np.asarray(v["params"]["merge_dense"]["kernel"])
    np.testing.assert_array_equal(model.merge_dense.weight.detach().numpy(), dense.T)

    audio_sd = from_jax_variables(loaded, model_type)
    spec.audio_tower().load_state_dict(audio_sd, strict=True)
    vision_sd = vision_from_jax_variables(loaded, model_type)
    spec.vision_tower().load_state_dict(vision_sd, strict=True)
    if not spec.tiny:
        final = "BatchNorm_1" if spec.vision_input_bn else "BatchNorm_0"
        np.testing.assert_array_equal(
            vision_sd["final_bn.running_var"].numpy(),
            v["batch_stats"]["vision_model"][final]["var"],
        )
        conv = np.asarray(v["params"]["audio_model"]["audio_embedding_layer"]["kernel"])
        np.testing.assert_array_equal(
            audio_sd["embedding_conv.weight"].numpy(), conv.transpose(3, 2, 0, 1)
        )


@pytest.fixture(scope="module")
def ckpts(variables, tmp_path_factory):
    """model_type → a .ckpt of that type's variables."""
    root = tmp_path_factory.mktemp("ckpts")
    paths = {}

    def get(model_type):
        if model_type not in paths:
            v = variables(model_type)
            paths[model_type] = str(root / f"{model_type}.ckpt")
            save_variables(paths[model_type], v["params"], v["batch_stats"])
        return paths[model_type]

    return get


def test_image_preprocessing_is_bit_equal(monkeypatch):
    """preprocess_frames on non-224 uint8 frames, with PIL's bilinear
    resize and with the nearest-neighbour fallback used where PIL is
    missing: the same bytes as the JAX package's."""
    rng = np.random.RandomState(12)
    for shape in ((2, 240, 320, 3), (1, 300, 257, 3), (224, 224, 3)):
        frames = rng.randint(0, 256, shape, dtype=np.uint8)
        ours = torch_api.preprocess_frames(frames)
        assert ours.shape[1:] == (224, 224, 3)
        np.testing.assert_array_equal(ours, jax_api.preprocess_frames(frames))
    monkeypatch.setitem(sys.modules, "PIL", None)  # `from PIL import Image` raises
    frames = rng.randint(0, 256, (1, 200, 350, 3), dtype=np.uint8)
    np.testing.assert_array_equal(
        torch_api.preprocess_frames(frames), jax_api.preprocess_frames(frames)
    )


def test_get_image_embedding_matches_jax(ckpts):
    """get_image_embedding on non-224 uint8 frames (resize, crop, 2x/255-1,
    bucket padding) through one checkpoint in both packages, with
    timestamps from frame_rate, for one array and for a list; tiny_L3
    keeps the vision tower cheap."""
    mt = "tiny_L3"
    frames = np.random.RandomState(13).randint(0, 256, (3, 240, 320, 3), dtype=np.uint8)
    jax_model = jax_api.ImageEmbeddingModel(ckpts(mt), model_type=mt)
    ours_model = torch_api.ImageEmbeddingModel(ckpts(mt), model_type=mt, device="cpu")
    emb_j, ts_j = jax_api.get_image_embedding(frames, 25.0, model=jax_model)
    emb_t, ts_t = torch_api.get_image_embedding(frames, 25.0, model=ours_model)
    np.testing.assert_array_equal(ts_t, ts_j)
    assert emb_t.shape == (3, 10)
    _close_f32(emb_t, np.asarray(emb_j))
    # A list of inputs with per-input frame rates: per-input results.
    embs_t, tss_t = torch_api.get_image_embedding([frames[:1], frames[1:]], [25.0, 30.0],
                                                  model=ours_model)
    embs_j, tss_j = jax_api.get_image_embedding([frames[:1], frames[1:]], [25.0, 30.0],
                                                model=jax_model)
    for e_t, e_j, t_t, t_j in zip(embs_t, embs_j, tss_t, tss_j):
        np.testing.assert_array_equal(t_t, t_j)
        _close_f32(e_t, np.asarray(e_j))


class _JaxEagerEmbedding:
    """JAX's cnn_L3_orig 'short' embedding function, unjitted, behind the
    ``embed_windows`` interface that JAX's get_audio_embedding calls (the
    jitted JAX extractor would spend most of this file's time compiling)."""

    sr = 48000

    def __init__(self, variables):
        self.variables = variables
        self.fn = jax_audio_embedding_fn("cnn_L3_orig", "short")

    def embed_windows(self, windows):
        return np.asarray(self.fn(self.variables, windows[:, None, :]))


def test_get_audio_embedding_linear_matches_jax(variables, ckpts):
    """get_audio_embedding(input_repr="linear") selects cnn_L3_orig and,
    from its .ckpt, gives JAX's rows and timestamps (JAX's
    get_audio_embedding over the same variables) at the f32 gate."""
    assert torch_api.INPUT_REPRS == jax_api.INPUT_REPRS
    assert torch_api.INPUT_REPRS["linear"] == "cnn_L3_orig"
    rng = np.random.RandomState(14)
    clip = (rng.randn(int(1.25 * 48000)) * 0.2).astype(np.float32)
    emb_j, ts_j = jax_api.get_audio_embedding(
        clip, 48000, model=_JaxEagerEmbedding(variables("cnn_L3_orig"))
    )
    emb_t, ts_t = torch_api.get_audio_embedding(
        clip, 48000, weights_path=ckpts("cnn_L3_orig"), input_repr="linear", device="cpu"
    )
    np.testing.assert_array_equal(ts_t, ts_j)
    # 60000 samples and half a window of front padding: 1 + ceil(36000 / 4800).
    assert emb_t.shape == (9, 512)
    _close_f32(emb_t, np.asarray(emb_j))
