"""The PyTorch port's cnn_L3_melspec2 embedding slice against the JAX package.

One set of flax variables (random init, perturbed BN statistics) is
carried across with ``from_jax_variables`` or through a ``.ckpt`` file,
and the same numpy audio goes through both packages on the CPU.
"""

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

from l3embedding_tpu import api as jax_api
from l3embedding_tpu.embed.extract import EmbeddingExtractor as JaxExtractor
from l3embedding_tpu.embed.extract import frame_uniform as jax_frame_uniform
from l3embedding_tpu.models import audio_embedding_fn as jax_embedding_fn
from l3embedding_tpu.models import build_model as jax_build_model
from l3embedding_tpu.training.checkpoints import save_variables
from l3embedding_torch import api as torch_api
from l3embedding_torch.compat.from_jax import from_jax_variables
from l3embedding_torch.embed.extract import EmbeddingExtractor, frame_uniform
from l3embedding_torch.models.embedding import AUDIO_POOLINGS, _pool_flatten, audio_embedding_fn
from l3embedding_torch.models.registry import MODELS, build_model
from l3embedding_torch.models.towers import L3AudioTower
from l3embedding_torch.training.checkpoints import load_variables
from torch_port_threads import one_torch_thread  # noqa: F401

MODEL = "cnn_L3_melspec2"


def _perturb(path, leaf):
    name = getattr(path[-1], "key", "")
    if name == "mean":
        return leaf + 0.05
    if name == "var":
        return leaf * 1.3 + 0.01
    return leaf


@pytest.fixture(scope="module")
def variables():
    """Full AVC variables of melspec2 (numpy), BN stats perturbed so the
    BN arithmetic is exercised."""
    model = jax_build_model(MODEL).module()
    v = jax.device_get(
        model.init(
            jax.random.PRNGKey(1),
            np.zeros((1, 224, 224, 3), np.float32),
            np.zeros((1, 1, 48000), np.float32),
            train=False,
        )
    )
    v = {"params": v["params"], "batch_stats": v["batch_stats"]}
    v["batch_stats"] = jax.tree_util.tree_map_with_path(_perturb, v["batch_stats"])
    return v


@pytest.fixture(scope="module")
def audio():
    return (np.random.RandomState(3).randn(2, 1, 48000) * 0.2).astype(np.float32)


def _port(variables, pooling, dtype=torch.float32, db_batch_global=False):
    fn = audio_embedding_fn(MODEL, pooling, compute_dtype=dtype, db_batch_global=db_batch_global)
    fn.tower.load_state_dict(from_jax_variables(variables, MODEL))
    return fn.eval()


def _row_cos(a, b):
    return [(u @ v) / (np.linalg.norm(u) * np.linalg.norm(v) + 1e-30) for u, v in zip(a, b)]


@pytest.mark.parametrize("pooling,dim", [("short", 512), ("original", 6144)])
def test_embedding_matches_jax_f32(variables, audio, pooling, dim):
    """f32: per-row cosine >= 0.99999 and max |Δ| <= 1e-3 · max|emb|."""
    theirs = np.asarray(jax_embedding_fn(MODEL, pooling)(variables, audio))
    ours = _port(variables, pooling)(torch.from_numpy(audio)).numpy()
    assert ours.shape == theirs.shape == (2, dim)
    assert min(_row_cos(ours, theirs)) >= 0.99999
    assert np.abs(ours - theirs).max() <= 1e-3 * np.abs(theirs).max()


@pytest.mark.parametrize("pooling,dim", [("short", 512), ("original", 6144)])
def test_embedding_matches_jax_bf16(variables, audio, pooling, dim):
    """bf16 compute in both (JAX compute_dtype=bfloat16): cosine >= 0.999,
    the BASELINE parity gate; bf16 rounds at different places in each."""
    theirs = np.asarray(
        jax_embedding_fn(MODEL, pooling, compute_dtype=jnp.bfloat16)(variables, audio)
    )
    ours = _port(variables, pooling, torch.bfloat16)(torch.from_numpy(audio)).numpy()
    assert ours.shape == theirs.shape == (2, dim)
    assert min(_row_cos(ours, theirs)) >= 0.999


def test_tower_output_matches_jax_f32(variables, audio):
    """The tower's own (B, 512) output: final BN (flax's BatchNorm_1), ReLU
    and the VALID (32, 24) pool after the embedding conv."""
    tower = jax_build_model(MODEL).module().audio_model
    sub = {k: variables[k]["audio_model"] for k in ("params", "batch_stats")}
    theirs = np.asarray(tower.apply(sub, audio, train=False))
    ours = _port(variables, "short").tower(torch.from_numpy(audio)).detach().numpy()
    assert ours.shape == theirs.shape == (2, 512)
    assert min(_row_cos(ours, theirs)) >= 0.99999
    assert np.abs(ours - theirs).max() <= 1e-3 * np.abs(theirs).max()


def test_db_batch_global_with_one_loud_row(variables, audio):
    """db_batch_global=True: the dB reference is the max over the whole
    batch, so with one loud row the quiet row's embedding changes; the
    port follows JAX in both modes."""
    quiet = audio * np.asarray([1.0, 0.01], np.float32)[:, None, None]
    x = torch.from_numpy(quiet)
    theirs_g = np.asarray(jax_embedding_fn(MODEL, "original", db_batch_global=True)(variables, quiet))
    ours_g = _port(variables, "original", db_batch_global=True)(x).numpy()
    assert min(_row_cos(ours_g, theirs_g)) >= 0.99999
    ours_ps = _port(variables, "original")(x).numpy()
    assert _row_cos(ours_ps[1:], ours_g[1:])[0] < 0.999


def test_checkpoint_loads_bit_exactly(variables, tmp_path):
    path = str(tmp_path / "model.ckpt")
    save_variables(path, variables["params"], variables["batch_stats"])
    loaded = load_variables(path)
    flat_ref = jax.tree_util.tree_leaves_with_path(variables)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(loaded))
    assert len(flat_got) == len(flat_ref)
    for key, ref in flat_ref:
        got = flat_got[key]
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert got.tobytes() == np.asarray(ref).tobytes()


@pytest.fixture(scope="module")
def extractors(variables, tmp_path_factory):
    """The JAX and the port extractor over one checkpoint file."""
    path = str(tmp_path_factory.mktemp("ckpt") / "model.ckpt")
    save_variables(path, variables["params"], variables["batch_stats"])
    return (
        JaxExtractor(path, MODEL, "short"),
        EmbeddingExtractor(path, MODEL, "short", device="cpu"),
    )


def test_extractor_matches_jax_on_unaligned_clip(extractors):
    """embed_audio on a clip whose length is not a hop multiple: the same
    rows (the trailing partial window dropped by the reference quirk) and
    the same embeddings, at the f32 tolerances."""
    jax_ext, ext = extractors
    rng = np.random.RandomState(5)
    clip = (rng.randn(48000 + 3 * 4800 + 1234) * 0.2).astype(np.float32)
    np.testing.assert_array_equal(frame_uniform(clip), jax_frame_uniform(clip))
    theirs = np.asarray(jax_ext.embed_audio(clip))
    ours = ext.embed_audio(clip)
    assert ours.shape == theirs.shape == (4, 512)
    assert min(_row_cos(ours, theirs)) >= 0.99999
    assert np.abs(ours - theirs).max() <= 1e-3 * np.abs(theirs).max()


def test_api_matches_jax_on_resampled_clip(extractors):
    """get_audio_embedding: int16 stereo PCM at 44.1 kHz, resampled and
    framed openl3-style, gives JAX's rows and timestamps."""
    jax_ext, ext = extractors
    rng = np.random.RandomState(6)
    pcm = (rng.randn(int(1.3 * 44100), 2) * 3000).astype(np.int16)
    emb_j, ts_j = jax_api.get_audio_embedding(pcm, 44100, model=jax_ext)
    emb_t, ts_t = torch_api.get_audio_embedding(pcm, 44100, model=ext)
    np.testing.assert_array_equal(ts_t, ts_j)
    assert emb_t.shape == np.asarray(emb_j).shape == (9, 512)
    assert min(_row_cos(emb_t, np.asarray(emb_j))) >= 0.99999


def test_openl3_framing_and_pcm_helpers_match_jax():
    rng = np.random.RandomState(7)
    pcm = (rng.randn(30000, 2) * 8000).astype(np.int16)
    mono = torch_api._to_mono_float(pcm)
    np.testing.assert_array_equal(mono, jax_api._to_mono_float(pcm))
    for center in (True, False):
        np.testing.assert_array_equal(
            torch_api._frame_openl3(mono, 48000, 0.1, center),
            jax_api._frame_openl3(mono, 48000, 0.1, center),
        )


def test_seeded_init_is_reproducible_and_he_scaled():
    a = EmbeddingExtractor(None, MODEL, "short", device="cpu").model.tower.state_dict()
    b = EmbeddingExtractor(None, MODEL, "short", fast=True, device="cpu").model.tower.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    w = a["blocks.6.conv.weight"]  # 256 → 512, fan_in 2304
    assert abs(w.std().item() - np.sqrt(2.0 / 2304)) < 0.1 * np.sqrt(2.0 / 2304)


@pytest.mark.parametrize("shape,pool", [((2, 32, 24, 8), (8, 8)), ((1, 13, 10, 3), (4, 3))])
def test_pool_flatten_same_padding_matches_flax(shape, pool):
    import flax.linen as nn

    feat = np.random.RandomState(8).randn(*shape).astype(np.float32)
    theirs = np.asarray(nn.max_pool(feat, pool, strides=pool, padding="SAME"))
    ours = _pool_flatten(torch.from_numpy(feat), pool).numpy()
    np.testing.assert_array_equal(ours, theirs.reshape(shape[0], -1))


def test_unported_model_types_raise():
    """The registry: a name outside the five reference types raises
    ValueError (as does an unknown front end); all five build, with the
    JAX registry's pooling tables and head widths."""
    from l3embedding_tpu.models import MODELS as JAX_MODELS

    with pytest.raises(ValueError, match="Invalid model type"):
        build_model("no_such_model")
    with pytest.raises(ValueError, match="frontend_kind"):
        L3AudioTower(frontend_kind="no_such_frontend")
    assert set(MODELS) == set(JAX_MODELS)
    for name, jax_spec in JAX_MODELS.items():
        spec = build_model(name)
        assert spec.audio_embedding_pooling == jax_spec.audio_embedding_pooling
        assert AUDIO_POOLINGS[name] == jax_spec.audio_embedding_pooling
        model = spec.module()
        assert model.merge_dense.out_features == jax_spec.module().layer_size
        assert isinstance(spec.audio_tower(), nn.Module)
    assert build_model("cnn_L3_melspec1").audio_embedding_pooling == {
        "original": (4, 8), "short": (16, 24)
    }
