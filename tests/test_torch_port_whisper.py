"""Whisper's audio encoder in the port (``models/whisper_encoder.py``,
``ops/frontend.whisper_log_mel``, ``embed/whisper.py``, ``05 --features
whisper``) against the plain reference ``tests/whisper_encoder_reference.py``
on seeded weights, on the CPU at a small size (d 64, 2 blocks, 4 heads,
16 mels, 200 positions, so a window is 4 s), never at the published
widths. The reference is held against Hugging
Face's ``WhisperEncoder`` and ``WhisperFeatureExtractor`` where
``transformers`` imports. No JAX here."""

import collections
import functools
import os

import numpy as np
import pytest
import torch
import whisper_encoder_reference as ref
from torch.profiler import ProfilerActivity, profile

from l3embedding_torch.data.audio_io import write_wav
from l3embedding_torch.embed import whisper
from l3embedding_torch.models.whisper_encoder import (
    LARGE_V3,
    WhisperDims,
    WhisperEncoder,
    build_encoder,
    load_whisper_state_dict,
    sinusoids,
)
from l3embedding_torch.ops.frontend import whisper_log_mel, whisper_mel_filters_f32
from l3embedding_torch.utils import trace

DIMS = WhisperDims(n_mels=16, n_audio_ctx=200, n_audio_state=64, n_audio_head=4, n_audio_layer=2)
WINDOW = 2 * DIMS.n_audio_ctx * 160  # 64,000 samples, 4 s


def _pcm(n, seed=0, scale=0.1):
    return (np.random.RandomState(seed).randn(n) * scale).astype(np.float32)


def _params(seed=7):
    return ref.random_params(DIMS.n_mels, DIMS.n_audio_state, DIMS.n_audio_layer, seed)


def _encoder(params, dtype=torch.float32):
    return load_whisper_state_dict(build_encoder(DIMS, dtype), params)


def _frame_err(got, want):
    """Each frame's |p − r| / |r|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want, axis=-1) / np.linalg.norm(want, axis=-1)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(min(4, torch.get_num_threads()))
    trace.clear()
    yield
    trace.clear()


@pytest.fixture(scope="module")
def params():
    return _params()


@pytest.fixture(scope="module")
def extractor(params):
    return whisper.WhisperExtractor(params, fast=False, device="cpu", dims=DIMS)


# ------------------------------------------------------------ front end


def test_mel_filters_match_the_reference():
    for n_mels in (16, 80, 128):
        np.testing.assert_allclose(whisper_mel_filters_f32(n_mels), ref.mel_filters(n_mels), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("n_mels", [16, 128])
def test_log_mel_matches_the_reference(n_mels):
    """Two windows, one loud and one quiet: the same features, each window
    clamped at its own max − 8 (float32: the STFT's and the product's
    roundings, ~1e-6 in log10)."""
    pcm = torch.from_numpy(np.stack([_pcm(WINDOW, 1, 0.3), _pcm(WINDOW, 2, 1e-4)]))
    got = whisper_log_mel(pcm, n_mels)
    want = ref.log_mel(pcm, n_mels)
    assert got.shape == want.shape == (2, n_mels, WINDOW // 160)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)
    alone = whisper_log_mel(pcm[1:], n_mels)
    np.testing.assert_array_equal(alone.numpy(), got[1:].numpy())


def test_log_mel_at_the_published_window():
    pcm = torch.from_numpy(_pcm(480_000, 3)[None])
    got = whisper_log_mel(pcm)
    assert got.shape == (1, 128, 3000)
    np.testing.assert_allclose(got.numpy(), ref.log_mel(pcm, 128).numpy(), atol=2e-5)


# ------------------------------------------------------------ the encoder


def test_sinusoids_match_the_reference():
    """Whisper computes the table in float32, whose products t·ω round by
    up to ~6e-5 at t ~1500 (the reference's are float64)."""
    np.testing.assert_allclose(sinusoids(1500, 1280).numpy(), ref.sinusoids(1500, 1280).numpy(), atol=1e-4)


def test_encoder_f32_matches_the_reference(params):
    mel = ref.log_mel(torch.from_numpy(np.stack([_pcm(WINDOW, 4), _pcm(WINDOW, 5)])), DIMS.n_mels)
    with torch.no_grad():
        got = _encoder(params)(mel)
    want = ref.encoder(params, mel, DIMS.n_audio_head)
    assert got.shape == want.shape == (2, DIMS.n_audio_ctx, DIMS.n_audio_state) and got.dtype == torch.float32
    assert _frame_err(got, want).max() < 1e-5


def test_encoder_bf16_within_its_rounding(params):
    """bf16 linears, convs and residual stream (LayerNorm statistics and the
    softmax in float32): each rounding is within 2^-9 of its value, and a
    frame passes ~8 of them a block, so a frame's error stays near 1e-2;
    the limits 2e-2 on the median frame and 4e-2 on the worst leave that
    room."""
    mel = ref.log_mel(torch.from_numpy(_pcm(WINDOW, 6)[None]), DIMS.n_mels)
    enc = _encoder(params, torch.bfloat16)
    assert enc.blocks[0].attn.query.weight.dtype == torch.bfloat16
    assert enc.blocks[0].attn_ln.weight.dtype == enc.positional_embedding.dtype == torch.float32
    with torch.no_grad():
        got = enc(mel)
    assert got.dtype == torch.bfloat16
    err = _frame_err(got.float(), ref.encoder(params, mel, DIMS.n_audio_head))
    assert np.median(err) < 2e-2 and err.max() < 4e-2, (np.median(err), err.max())


def test_seeded_init_is_repeatable_and_shaped():
    a, b = build_encoder(DIMS), build_encoder(DIMS)
    a.reset_parameters(torch.Generator().manual_seed(3))
    b.reset_parameters(torch.Generator().manual_seed(3))
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), name
    sd = a.state_dict()
    assert abs(float(sd["blocks.0.mlp.0.weight"].std()) - 0.02) < 1e-3
    assert abs(float(sd["conv1.weight"].std()) - (2.0 / (DIMS.n_mels * 3)) ** 0.5) < 0.02
    assert abs(float(sd["ln_post.weight"].mean()) - 1.0) < 0.05
    assert torch.equal(sd["positional_embedding"], sinusoids(DIMS.n_audio_ctx, DIMS.n_audio_state))


def test_published_sizes():
    """large-v3's encoder: 32 blocks of 19.68 M parameters and a 5.4 M stem,
    ~635 M in all; the blocks' linears 19.66 M each."""
    with torch.device("meta"):
        enc = WhisperEncoder(LARGE_V3)
    total = sum(p.numel() for p in enc.parameters())
    block = sum(p.numel() for p in enc.blocks[0].parameters())
    linear = sum(p.numel() for n, p in enc.blocks[0].named_parameters() if n.endswith("weight") and p.dim() == 2)
    assert LARGE_V3.n_mlp == 5120 and LARGE_V3.n_audio_state // LARGE_V3.n_audio_head == 64
    assert 19.67e6 < block < 19.69e6 and 19.65e6 < linear < 19.67e6
    assert 634e6 < total < 636e6


# ------------------------------------------------------------ loaders


def _hf_names(params, prefix=""):
    layer = {"attn.query": "self_attn.q_proj", "attn.key": "self_attn.k_proj", "attn.value": "self_attn.v_proj",
             "attn.out": "self_attn.out_proj", "attn_ln": "self_attn_layer_norm", "mlp.0": "fc1", "mlp.2": "fc2",
             "mlp_ln": "final_layer_norm"}
    out = {}
    for name, value in params.items():
        if name.startswith("blocks."):
            _, i, rest = name.split(".", 2)
            mod, leaf = rest.rsplit(".", 1)
            name = f"layers.{i}.{layer[mod]}.{leaf}"
        elif name.startswith("ln_post."):
            name = "layer_norm." + name.split(".", 1)[1]
        out[prefix + name] = value
    out[prefix + "embed_positions.weight"] = sinusoids(DIMS.n_audio_ctx, DIMS.n_audio_state)
    return out


@pytest.mark.parametrize("names", ["whisper", "whisper_checkpoint", "hf", "hf_model"])
def test_loaders_give_the_reference_rows(names, params):
    """Whisper's names (bare, or as a whole checkpoint holds them under
    encoder. beside the decoder's) and Hugging Face's (bare, or under
    model.encoder.) load to the same encoder."""
    sd = {"whisper": dict(params),
          "whisper_checkpoint": {**{"encoder." + k: v for k, v in params.items()},
                                 "encoder.positional_embedding": sinusoids(DIMS.n_audio_ctx, DIMS.n_audio_state),
                                 "decoder.token_embedding.weight": torch.zeros(3, 4)},
          "hf": _hf_names(params),
          "hf_model": {**_hf_names(params, "model.encoder."), "proj_out.weight": torch.zeros(3, 4)}}[names]
    mel = ref.log_mel(torch.from_numpy(_pcm(WINDOW, 8)[None]), DIMS.n_mels)
    with torch.no_grad():
        got = _encoder(sd)(mel)
    assert _frame_err(got, ref.encoder(params, mel, DIMS.n_audio_head)).max() < 1e-5


def test_loader_refuses_a_wrong_state_dict(params):
    with pytest.raises(ValueError, match="missing"):
        _encoder({k: v for k, v in params.items() if k != "conv2.bias"})
    with pytest.raises(ValueError, match="shape mismatch"):
        _encoder({**params, "conv2.bias": torch.zeros(3)})


@pytest.mark.parametrize("kind", ["whisper_pt", "hf_safetensors"])
def test_extractor_reads_checkpoint_files(kind, params, tmp_path):
    """Whisper's .pt (its model_state_dict beside its dims) and Hugging
    Face's .safetensors, where the safetensors package imports."""
    if kind == "whisper_pt":
        path = str(tmp_path / "large.pt")
        torch.save({"dims": {"n_mels": 16}, "model_state_dict": {"encoder." + k: v for k, v in params.items()}}, path)
    else:
        save_file = pytest.importorskip("safetensors.torch").save_file
        path = str(tmp_path / "model.safetensors")
        save_file({k: v.contiguous() for k, v in _hf_names(params, "model.encoder.").items()}, path)
    ext = whisper.WhisperExtractor(path, fast=False, device="cpu", dims=DIMS)
    for name in ("blocks.1.mlp.2.weight", "blocks.0.attn.key.weight", "ln_post.bias"):
        assert torch.equal(ext.model.encoder.state_dict()[name], params[name])


# ------------------------------------------------------------ transformers


def _transformers():
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_FLAX", "0")
    return pytest.importorskip("transformers")


def test_reference_matches_transformers_encoder(params):
    transformers = _transformers()
    from transformers.models.whisper.modeling_whisper import WhisperEncoder as HFEncoder

    cfg = transformers.WhisperConfig(num_mel_bins=DIMS.n_mels, d_model=DIMS.n_audio_state,
                                     encoder_layers=DIMS.n_audio_layer,
                                     encoder_attention_heads=DIMS.n_audio_head,
                                     encoder_ffn_dim=4 * DIMS.n_audio_state,
                                     max_source_positions=DIMS.n_audio_ctx, attn_implementation="eager")
    hf = HFEncoder(cfg).eval()
    hf.load_state_dict(_hf_names(params))
    mel = ref.log_mel(torch.from_numpy(np.stack([_pcm(WINDOW, 9), _pcm(WINDOW, 10)])), DIMS.n_mels)
    with torch.no_grad():
        theirs = hf(mel).last_hidden_state
    assert _frame_err(ref.encoder(params, mel, DIMS.n_audio_head), theirs).max() < 1e-5


def test_reference_log_mel_matches_transformers_features():
    _transformers()
    from transformers import WhisperFeatureExtractor

    fe = WhisperFeatureExtractor(feature_size=128)
    pcm = _pcm(480_000, 11, 0.2)
    theirs = fe(pcm, sampling_rate=16000, return_tensors="np")["input_features"][0]
    ours = ref.log_mel(torch.from_numpy(pcm[None]), 128)[0].numpy()
    assert theirs.shape == ours.shape == (128, 3000)
    np.testing.assert_allclose(ours, theirs, atol=1e-4)


# ------------------------------------------------------------ the extractor


def test_frame_whisper_windows_and_padding():
    clip = _pcm(2 * WINDOW + 1234, 12)
    windows, pad = whisper.frame_whisper(clip, WINDOW)
    assert windows.shape == (3, WINDOW) and pad == WINDOW - 1234
    np.testing.assert_array_equal(windows.reshape(-1)[: len(clip)], clip)
    assert not windows.reshape(-1)[len(clip):].any()
    short, pad = whisper.frame_whisper(clip[:5000], WINDOW)
    assert short.shape == (1, WINDOW) and pad == WINDOW - 5000
    assert whisper.frame_whisper(clip[:WINDOW], WINDOW)[1] == 0
    assert whisper.frame_whisper(np.zeros(0, np.float32), WINDOW)[0].shape == (1, WINDOW)


def test_published_window_and_buckets():
    assert whisper.frame_whisper(np.ones(30 * 16000 + 1, np.float32))[0].shape == (2, 480_000)
    ext = whisper.WhisperExtractor.__new__(whisper.WhisperExtractor)
    assert [ext._bucket_size(n) for n in (1, 3, 5, 17, 32, 33, 70)] == [1, 4, 8, 32, 32, 64, 96]


def test_extractor_rows_match_the_reference(extractor, params):
    """A clip of 2.3 windows: 3 windows, the last zero-padded, each window's
    (200, 64) rows the reference's."""
    clip = _pcm(int(2.3 * WINDOW), 13)
    rows = extractor.embed_audio(clip)
    windows, _ = whisper.frame_whisper(clip, WINDOW)
    want = ref.embed(params, torch.from_numpy(windows), DIMS.n_mels, DIMS.n_audio_head)
    assert rows.shape == (3, DIMS.n_audio_ctx, DIMS.n_audio_state) and rows.dtype == np.float32
    assert _frame_err(rows, want).max() < 1e-5


def test_a_short_clip_is_one_window(extractor, params):
    clip = _pcm(WINDOW // 3, 14)
    rows = extractor.embed_audio(clip)
    padded = np.zeros((1, WINDOW), np.float32)
    padded[0, : len(clip)] = clip
    assert rows.shape == (1, DIMS.n_audio_ctx, DIMS.n_audio_state)
    assert _frame_err(rows, ref.embed(params, torch.from_numpy(padded), DIMS.n_mels, DIMS.n_audio_head)).max() < 1e-5


def test_a_window_gives_the_same_rows_in_any_call(extractor):
    """Two clips' windows packed into one call (5 windows in a bucket of 8)
    give each clip's rows as its own call does."""
    a, b = _pcm(int(1.5 * WINDOW), 15), _pcm(int(2.7 * WINDOW), 16)
    (wa, pa), (wb, pb) = whisper.frame_whisper(a, WINDOW), whisper.frame_whisper(b, WINDOW)
    packed = extractor.embed_windows_async(np.concatenate([wa, wb]), pa + pb).result()
    assert packed.shape[0] == 5
    np.testing.assert_allclose(packed[:2], extractor.embed_audio(a), rtol=0, atol=2e-5)
    np.testing.assert_allclose(packed[2:], extractor.embed_audio(b), rtol=0, atol=2e-5)
    np.testing.assert_allclose(packed[3:4], extractor.embed_windows(wb[1:2]), rtol=0, atol=2e-5)


@pytest.mark.cuda
def test_side_download_gives_the_same_rows_on_the_card(params):
    """On the card the rows' copy back runs on a second stream behind the
    forward; with three calls in flight each call's rows equal, bit for bit,
    those of an extractor that copies on the call's own stream."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    side = whisper.WhisperExtractor(params, fast=False, device="cuda", dims=DIMS)
    assert side._download_streams[0] is not side._streams[0]
    own = whisper.WhisperExtractor(params, fast=False, device="cuda", dims=DIMS)
    own._download_streams = list(own._streams)
    calls = [np.stack([_pcm(WINDOW, 30 + 4 * i + j) for j in range(4)]) for i in range(3)]
    handles = [side.embed_windows_async(w) for w in calls]
    got = [h.result().copy() for h in handles]
    for w, rows in zip(calls, got):
        np.testing.assert_array_equal(rows, own.embed_windows_async(w).result())


def test_l3_rows_keep_their_shape():
    """The extractor's shared download keeps an L3 tower's (n, dim) rows."""
    from l3embedding_torch.embed.extract import EmbeddingExtractor

    ext = EmbeddingExtractor(None, "tiny_L3", "short", device="cpu")
    assert ext.embed_audio(_pcm(int(1.3 * 48000), 17), 0.1).shape == (4, 350)


# ------------------------------------------------------------ spans and counters


def _parents(spans):
    by_id = {s.id: s for s in spans}
    return collections.Counter((s.name, by_id[s.parent].name if s.parent else None) for s in spans)


def test_spans_and_counters(extractor):
    """One extract.call a public call, counting its windows and their zero
    padding beside rows and bucket rows; the front end and the stem under
    the forward, and one encoder.attn a block; nothing without a profiler."""
    clips = [_pcm(int(2.25 * WINDOW), 18), _pcm(WINDOW, 19)]
    extractor.embed_audio(clips[0])
    assert trace.spans() == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for c in clips:
            extractor.embed_audio(c)
        windows, _ = whisper.frame_whisper(clips[1], WINDOW)
        extractor.embed_windows(np.concatenate([windows] * 5))
    spans = trace.spans()
    n, blocks = 3, DIMS.n_audio_layer
    assert _parents(spans) == {
        ("extract.call", None): n, ("extract.upload", "extract.call"): n + 2,
        ("extract.forward", "extract.call"): n, ("encoder.frontend", "extract.forward"): n,
        ("encoder.stem", "extract.forward"): n, ("encoder.attn", "extract.forward"): n * blocks}
    calls = [s.counters for s in spans if s.name == "extract.call"]
    assert calls == [{"windows": 3, "pad_samples": int(0.75 * WINDOW), "rows": 3, "bucket_rows": 4},
                     {"windows": 1, "pad_samples": 0, "rows": 1, "bucket_rows": 1},
                     {"windows": 5, "pad_samples": 0, "rows": 5, "bucket_rows": 8}]
    assert 0 < trace.share("encoder.attn", "extract.call", n) < 100
    assert {"encoder.frontend", "encoder.stem", "encoder.attn"} <= {e.name for e in prof.events()}


# ------------------------------------------------------------ 05 --features whisper


def test_05_features_whisper(tmp_path, monkeypatch, params, caplog):
    """The 05 CLI's whisper route writes each file's frame rows (windows ·
    200, 64) as the extractor gives them, with a warning when no weights
    are given; the same rows from a weights file."""
    from l3embedding_torch.cli import generate_embedding_samples as cli

    data = tmp_path / "dcase2013"
    lengths = {1: [1.2, 9.5], 2: [4.0]}
    for fold, secs in lengths.items():
        (data / f"fold{fold}").mkdir(parents=True)
        for i, s in enumerate(secs):
            write_wav(str(data / f"fold{fold}" / f"bus{fold}{i}.wav"), _pcm(int(s * 16000), 20 + i), 16000)
    monkeypatch.setattr(cli, "WhisperExtractor", functools.partial(whisper.WhisperExtractor, dims=DIMS))
    weights = str(tmp_path / "w.pt")
    torch.save(params, weights)
    outs = {}
    for name, extra in (("random", []), ("weights", ["--whisper-weights", weights])):
        out = str(tmp_path / name)
        cli.main(["--features", "whisper", "--device", "cpu", *extra, "dcase2013", str(data), out])
        outs[name] = os.path.join(out, "features", "dcase2013", "whisper")
    assert "random init" in caplog.text
    ext = whisper.WhisperExtractor(params, fast=False, device="cpu", dims=DIMS)
    for fold, secs in lengths.items():
        for i, s in enumerate(secs):
            f = os.path.join(outs["weights"], f"fold{fold}", f"bus{fold}{i}.npz")
            got = np.load(f)["X"]
            n = -(-int(s * 16000) // WINDOW)
            assert got.shape == (n * DIMS.n_audio_ctx, DIMS.n_audio_state)
            want = ext.embed_file(str(data / f"fold{fold}" / f"bus{fold}{i}.wav"))
            np.testing.assert_allclose(got, want.reshape(-1, DIMS.n_audio_state), atol=2e-5)
            rand = np.load(os.path.join(outs["random"], f"fold{fold}", f"bus{fold}{i}.npz"))["X"]
            assert rand.shape == got.shape and not np.allclose(rand, got)
