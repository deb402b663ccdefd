"""The PyTorch port's extraction from files against the JAX package: device
framing, the `devices` split, exported artifacts, load_model /
load_embedding, the audio and video readers, and the file API and CLI.

One set of flax variables per model type (random, BN statistics away from
identity) is written to a ``.ckpt`` with the JAX package's
``save_variables`` and read by both packages; the same numpy inputs go
through both on the CPU. f32 rows are held at cosine >= 0.99999 against
JAX, and two port paths that feed the tower the same tensor at exact
equality.
"""

import json
import os
import subprocess
import sys
import wave

import numpy as np
import pytest
import torch

import jax

from l3embedding_tpu import api as jax_api
from l3embedding_tpu.data import audio_io as jax_audio_io
from l3embedding_tpu.data import video_io as jax_video_io
from l3embedding_tpu.embed.extract import EmbeddingExtractor as JaxExtractor
from l3embedding_tpu.embed.extract import load_exported_embedding as jax_load_exported
from l3embedding_tpu.models import audio_embedding_fn as jax_embedding_fn
from l3embedding_tpu.models import build_model as jax_build_model
from l3embedding_tpu.models.loading import load_embedding as jax_load_embedding
from l3embedding_tpu.models.loading import load_model as jax_load_model
from l3embedding_tpu.training.checkpoints import save_variables
from l3embedding_torch import api
from l3embedding_torch.data import audio_io, video_io
from l3embedding_torch.embed import extract
from l3embedding_torch.embed.extract import (
    EmbeddingExtractor,
    frame_uniform,
    load_exported_embedding,
    split_bucket,
)
from l3embedding_torch.models import loading
from torch_port_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = "tiny_L3"
SR = 48000


def _leaf(rng, path, shape):
    name = getattr(path[-1], "key", "")
    if name == "kernel":  # conv HWIO or dense (in, out): He-normal scale
        return rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[:-1]))
    if name == "scale":
        return 1.0 + 0.1 * rng.randn(*shape)
    if name == "var":
        return 1.0 + 0.3 * np.abs(rng.randn(*shape))
    return 0.05 * rng.randn(*shape)  # biases and means


def _variables(model_type):
    model = jax_build_model(model_type).module()
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), np.zeros((1, 224, 224, 3), np.float32),
        np.zeros((1, 1, SR), np.float32), train=False))
    rng = np.random.RandomState(sum(map(ord, model_type)))
    return {k: jax.tree_util.tree_map_with_path(
        lambda p, s: _leaf(rng, p, s.shape).astype(np.float32), shapes[k])
        for k in ("params", "batch_stats")}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """model_type → a .ckpt of that type's AVC variables, written by JAX."""
    root = tmp_path_factory.mktemp("ckpts")
    paths = {}

    def get(model_type=TINY):
        if model_type not in paths:
            v = _variables(model_type)
            paths[model_type] = str(root / f"{model_type}.ckpt")
            save_variables(paths[model_type], v["params"], v["batch_stats"])
        return paths[model_type]

    return get


def _min_cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    return min((u @ v) / (np.linalg.norm(u) * np.linalg.norm(v) + 1e-30) for u, v in zip(a, b))


def _clip(seconds=1.37, seed=0):
    """A clip that is not hop-aligned, with a loud tail past its last
    window: under the batch-global dB quirk, bucket-padding windows that
    saw that tail would shift every real row."""
    x = (np.random.RandomState(seed).randn(int(seconds * SR)) * 0.05).astype(np.float32)
    x[-3000:] *= 15.0
    return x


@pytest.fixture(scope="module")
def extractors(ckpt):
    """(package, db_batch_global) → a tiny_L3 extractor on the same .ckpt."""
    cache = {}

    def get(package, dbg):
        key = (package, dbg)
        if key not in cache:
            if package == "jax":
                cache[key] = JaxExtractor(ckpt(), TINY, "short", db_batch_global=dbg, device_framing=True)
            else:
                cache[key] = EmbeddingExtractor(ckpt(), TINY, "short", db_batch_global=dbg, device="cpu")
        return cache[key]

    return get


@pytest.mark.parametrize("dbg", [False, True], ids=["per_sample_db", "batch_global_db"])
@pytest.mark.parametrize("device_framing", [True, False], ids=["device_framing", "host_framing"])
def test_framing_matches_jax(extractors, device_framing, dbg):
    """Port and JAX on one .ckpt, the same 1.37 s clip, each with the same
    framing: rows at cosine >= 0.99999."""
    clip = _clip()
    theirs = np.asarray(extractors("jax", dbg).embed_audio(clip, device_framing=device_framing))
    ours = extractors("torch", dbg).embed_audio(clip, device_framing=device_framing)
    assert ours.shape == theirs.shape == (4, 350)
    assert _min_cos(ours, theirs) >= 0.99999


@pytest.mark.parametrize("dbg", [False, True], ids=["per_sample_db", "batch_global_db"])
def test_device_framing_equals_host_framing_exactly(extractors, dbg):
    """Device framing feeds the tower the host path's tensor: equal rows.
    It uploads the clip once; host framing uploads every real window."""
    ex = extractors("torch", dbg)
    clip = _clip()
    b0 = ex.bytes_uploaded
    host = ex.embed_audio(clip, device_framing=False)
    b1 = ex.bytes_uploaded
    dev = ex.embed_audio(clip, device_framing=True)
    np.testing.assert_array_equal(dev, host)
    assert b1 - b0 == 4 * SR * 4
    assert ex.bytes_uploaded - b1 == clip.size * 4


def test_padding_rows_are_zeroed_on_the_device(extractors, monkeypatch):
    """The trap: without the zeroing, the bucket's padding windows see the
    clip's loud tail and, under the batch-global dB quirk, change the real
    rows. The test clip shows it."""
    ex = extractors("torch", True)
    clip = _clip()
    want = ex.embed_audio(clip, device_framing=False)
    monkeypatch.setattr(torch, "where", lambda keep, a, b: a)
    unmasked = ex.embed_audio(clip, device_framing=True)
    assert np.abs(unmasked - want).max() > 1e-3 * np.abs(want).max()


def test_melspec2_device_framing_at_full_width(ckpt):
    """cnn_L3_melspec2 (256 mels, 512 channels) on a 1.1 s clip (2 windows,
    bucket 16): device framing equals host framing, and the rows hold
    against JAX's embedding function on the same windows."""
    path = ckpt("cnn_L3_melspec2")
    ex = EmbeddingExtractor(path, "cnn_L3_melspec2", "short", device="cpu")
    clip = (np.random.RandomState(4).randn(int(1.1 * SR)) * 0.2).astype(np.float32)
    dev = ex.embed_audio(clip, device_framing=True)
    np.testing.assert_array_equal(dev, ex.embed_audio(clip, device_framing=False))
    windows = frame_uniform(clip)
    theirs = np.asarray(jax_embedding_fn("cnn_L3_melspec2", "short")(_variables("cnn_L3_melspec2"),
                                                                        windows[:, None, :]))
    assert dev.shape == theirs.shape == (2, 512)
    assert _min_cos(dev, theirs) >= 0.99999


def test_short_clip_takes_the_host_path(extractors, monkeypatch):
    """A clip shorter than one window is framed on the host (centered
    padding), device_framing or not, as in JAX."""
    ex = extractors("torch", False)
    clip = _clip(0.7)

    def refuse(*a, **k):
        raise AssertionError("the device framer ran on a short clip")

    monkeypatch.setattr(ex, "_embed_device_framed", refuse)
    ours = ex.embed_audio(clip, device_framing=True)
    theirs = np.asarray(extractors("jax", False).embed_audio(clip, device_framing=True))
    assert ours.shape == theirs.shape == (1, 350)
    assert _min_cos(ours, theirs) >= 0.99999


@pytest.mark.parametrize("n,k,bucket", [(5, 3, 18), (16, 3, 18), (17, 4, 32), (600, 7, 1029)])
def test_split_bucket_rounds_up_to_the_device_count(n, k, bucket):
    """The bucket, rounded up to a multiple of the device count, as JAX's
    mesh path rounds it (extract.py:221-225)."""
    assert split_bucket(n, k) == bucket
    jax_bucket = extract._bucket(n)
    assert split_bucket(n, k) == -(-jax_bucket // k) * k


def test_devices_split_rows_equal_one_device(extractors, ckpt):
    """Three CPU "devices": the model replicated on each, a bucket of 18
    for 5 windows split into chunks of 6; the rows equal one device's."""
    one = extractors("torch", False)
    split = EmbeddingExtractor(ckpt(), TINY, "short", devices=["cpu"] * 3)
    assert len(split.models) == 3 and split.device == torch.device("cpu")
    seen = []
    for m in split.models:
        m.register_forward_hook(lambda mod, args, out: seen.append(args[0].shape[0]))
    rng = np.random.RandomState(5)
    for n, chunks in ((5, [6, 6, 6]), (20, [11, 11, 11])):
        seen.clear()
        w = (rng.randn(n, SR) * 0.1).astype(np.float32)
        np.testing.assert_array_equal(split.embed_windows(w), one.embed_windows(w))
        assert seen == chunks


def test_devices_force_host_framing(extractors, ckpt, monkeypatch):
    """`devices` frames on the host even with device_framing=True (as a
    mesh does in JAX)."""
    split = EmbeddingExtractor(ckpt(), TINY, "short", devices=["cpu", "cpu"], device_framing=True)
    monkeypatch.setattr(split, "_embed_device_framed", lambda *a, **k: pytest.fail("device framer ran"))
    clip = _clip()
    np.testing.assert_array_equal(split.embed_audio(clip), extractors("torch", False).embed_audio(clip))


@pytest.mark.parametrize("n", [5, 20])
def test_devices_with_batch_global_db_match_one_device_and_jax(extractors, ckpt, n):
    """Batch-global dB over three CPU "devices": the dB reference is a max
    over the whole bucket, as JAX's sharded mesh keeps it, so the model sits
    on the first device only and every bucket runs whole there. The rows
    equal one device's exactly and JAX's at the f32 gate; the windows vary
    in level, so a per-chunk reference would change them."""
    split = EmbeddingExtractor(ckpt(), TINY, "short", db_batch_global=True, devices=["cpu"] * 3)
    assert len(split.models) == 1
    seen = []
    split.model.register_forward_hook(lambda mod, args, out: seen.append(args[0].shape[0]))
    rng = np.random.RandomState(7)
    w = (rng.randn(n, SR) * rng.uniform(0.01, 1.0, (n, 1))).astype(np.float32)
    ours = split.embed_windows(w)
    assert seen == [extract._bucket(n)]
    np.testing.assert_array_equal(ours, extractors("torch", True).embed_windows(w))
    theirs = np.asarray(extractors("jax", True).embed_windows(w))
    assert _min_cos(ours, theirs) >= 0.99999


def _export(ckpt_path, prefix, embedding):
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "export_embedding_model.py"), ckpt_path,
         "--model-type", TINY, "--embedding", embedding, "--pooling", "short", "--output", prefix],
        capture_output=True, text=True,
        env={**os.environ, "JAX_PLATFORMS": "cpu", "L3_FORCE_PLATFORM": "cpu"},
    )
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_load_exported_embedding_matches_jax(ckpt, tmp_path):
    """tools/export_embedding_model.py's audio artifact (the audio tower's
    params and batch_stats only): the port's extractor from it equals the
    port's extractor from the full AVC .ckpt, and holds against JAX's
    load_exported_embedding."""
    prefix = str(tmp_path / "exported_audio")
    _export(ckpt(), prefix, "audio")
    ours = load_exported_embedding(prefix, device="cpu")
    assert (ours.model_type, ours.pooling_type) == (TINY, "short")
    windows = (np.random.RandomState(6).randn(3, SR) * 0.1).astype(np.float32)
    rows = ours.embed_windows(windows)
    np.testing.assert_array_equal(rows, EmbeddingExtractor(ckpt(), TINY, "short", device="cpu").embed_windows(windows))
    assert _min_cos(rows, np.asarray(jax_load_exported(prefix).embed_windows(windows))) >= 0.99999


@pytest.mark.parametrize("export", ["vision", "frontend"])
def test_load_exported_embedding_refuses_non_audio(tmp_path, export):
    """A vision or front-end descriptor raises JAX's ValueError."""
    prefix = str(tmp_path / f"exported_{export}")
    with open(prefix + ".json", "w") as f:
        json.dump({"export": export, "model_type": TINY, "pooling_type": "short"}, f)
    for loader in (load_exported_embedding, jax_load_exported):
        with pytest.raises(ValueError, match="audio embeddings"):
            loader(prefix)


def test_load_model_matches_jax(ckpt):
    """load_model: the AVC model with the .ckpt's weights; its logits hold
    against JAX's model.apply on the same inputs. Without weights, a
    seeded random model."""
    model, state = loading.load_model(ckpt(), TINY, device="cpu")
    assert not model.training and set(state) == set(model.state_dict())
    jmodel, jvars = jax_load_model(ckpt(), TINY)
    rng = np.random.RandomState(7)
    video = (rng.rand(2, 224, 224, 3) * 2 - 1).astype(np.float32)
    audio = (rng.randn(2, 1, SR) * 0.1).astype(np.float32)
    ours = model(torch.from_numpy(video), torch.from_numpy(audio)).detach().numpy()
    theirs = np.asarray(jmodel.apply(jvars, video, audio, train=False))
    assert ours.shape == theirs.shape == (2, 2)
    assert _min_cos(ours.reshape(1, -1), theirs.reshape(1, -1)) >= 0.99999
    a, _ = loading.load_model(None, TINY, device="cpu")
    b, _ = loading.load_model("", TINY, device="cpu")
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k


@pytest.mark.parametrize("embedding_type", ["audio", "vision"])
def test_load_embedding_matches_jax(ckpt, embedding_type):
    """load_embedding's callable on a batch, against JAX's, on one .ckpt."""
    rng = np.random.RandomState(8)
    if embedding_type == "audio":
        batch = (rng.randn(2, 1, SR) * 0.1).astype(np.float32)
    else:
        batch = (rng.rand(2, 224, 224, 3) * 2 - 1).astype(np.float32)
    ours = loading.load_embedding(ckpt(), TINY, embedding_type, "short", device="cpu")
    theirs = np.asarray(jax_load_embedding(ckpt(), TINY, embedding_type, "short")(batch))
    assert ours.model_type == TINY
    got = ours(batch).numpy()
    assert got.shape == theirs.shape and got.shape[0] == 2
    assert _min_cos(got, theirs) >= 0.99999


def test_load_model_refuses_h5_and_unknown_embedding_types(ckpt, tmp_path):
    """A Keras .h5 goes through the Keras importer, which refuses a file
    whose layers the model type lacks (tiny_L3 has no Keras layout; the
    .h5 cases are tests/test_torch_port_keras.py); an unknown embedding
    type raises."""
    from l3embedding_tpu.compat.keras_synth import synthesize_keras_h5

    h5 = str(tmp_path / "weights.h5")
    synthesize_keras_h5(h5, np.random.RandomState(0))
    with pytest.raises(ValueError, match="more Keras layers than targets in vision_model"):
        loading.load_model(h5, TINY, device="cpu")
    with pytest.raises(ValueError, match="Invalid embedding type"):
        loading.load_embedding(ckpt(), TINY, "text", "short", device="cpu")


@pytest.mark.parametrize("width", [1, 2, 3, 4])
def test_read_wav_matches_jax(tmp_path, width):
    """8-, 16-, 24- and 32-bit PCM WAV, stereo, random bytes: the same
    int16 samples and rate as JAX's reader."""
    path = str(tmp_path / f"w{width}.wav")
    raw = np.random.RandomState(width).randint(0, 256, 2 * 1000 * width, dtype=np.uint8).tobytes()
    with wave.open(path, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(width)
        w.setframerate(22050)
        w.writeframes(raw)
    ours, sr = audio_io.read_wav(path)
    theirs, jsr = jax_audio_io.read_wav(path)
    assert ours.dtype == np.int16 and ours.shape == (1000, 2) and sr == jsr == 22050
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("kind", ["npy", "npz", "wav_float32"])
def test_read_audio_matches_jax(tmp_path, kind):
    """.npy (samples then the rate), .npz (audio, sr) and WAV read as
    float32: the same arrays and rate as JAX's read_audio."""
    pcm = (np.random.RandomState(9).randn(3000) * 5000).astype(np.int16)
    if kind == "npy":
        path = str(tmp_path / "a.npy")
        np.save(path, np.concatenate([pcm.astype(np.int64), [16000]]))
        dtype = "int16"
    elif kind == "npz":
        path = str(tmp_path / "a.npz")
        np.savez(path, audio=pcm, sr=16000)
        dtype = "int16"
    else:
        path = str(tmp_path / "a.wav")
        jax_audio_io.write_wav(path, pcm, 16000)
        dtype = "float32"
    ours, sr = audio_io.read_audio(path, dtype=dtype)
    theirs, jsr = jax_audio_io.read_audio(path, dtype=dtype)
    assert sr == jsr == 16000 and ours.dtype == theirs.dtype
    np.testing.assert_array_equal(ours, theirs)


def test_load_audio_and_to_mono_match_jax(tmp_path):
    """A stereo 44.1 kHz WAV → mono float32 at 48 kHz (channel mean,
    polyphase resampling), and to_mono_int16: equal to JAX's."""
    stereo = (np.random.RandomState(10).randn(44100, 2) * 6000).astype(np.int16)
    path = str(tmp_path / "s.wav")
    audio_io.write_wav(path, stereo, 44100)
    ours = audio_io.load_audio(path, SR)
    assert ours.dtype == np.float32 and ours.shape == (SR,)
    np.testing.assert_array_equal(ours, jax_audio_io.load_audio(path, SR))
    np.testing.assert_array_equal(audio_io.to_mono_int16(stereo), jax_audio_io.to_mono_int16(stereo))


def test_write_wav_matches_jax(tmp_path):
    """Float (clipped, ×32767) and int16 input, mono and stereo: the same
    file bytes as JAX's write_wav."""
    rng = np.random.RandomState(11)
    for data in (rng.uniform(-1.2, 1.2, 500).astype(np.float32),
                 (rng.randn(400, 2) * 3000).astype(np.int16)):
        ours, theirs = str(tmp_path / "o.wav"), str(tmp_path / "t.wav")
        audio_io.write_wav(ours, data, 8000)
        jax_audio_io.write_wav(theirs, data, 8000)
        with open(ours, "rb") as a, open(theirs, "rb") as b:
            assert a.read() == b.read()


def test_ffmpeg_readers_raise_without_ffmpeg(tmp_path, monkeypatch):
    """Without an ffmpeg binary, a container that needs it raises the same
    RuntimeError as JAX's reader."""
    path = str(tmp_path / "a.flac")
    open(path, "wb").close()
    for mod in (audio_io, jax_audio_io):
        monkeypatch.setattr(mod, "_ffmpeg_path", lambda: None)
        with pytest.raises(RuntimeError, match="ffmpeg not available"):
            mod.read_via_ffmpeg(path)
        with pytest.raises(RuntimeError, match="ffmpeg not available"):
            mod.read_audio(path)


@pytest.mark.parametrize("ext", ["npy", "npz"])
def test_read_video_matches_jax(tmp_path, ext):
    """Pre-decoded frame dumps: .npy memory-mapped, .npz's ``video``; the
    same frames as JAX's read_video."""
    frames = np.random.RandomState(12).randint(0, 256, (4, 20, 30, 3), dtype=np.uint8)
    path = str(tmp_path / f"v.{ext}")
    if ext == "npy":
        np.save(path, frames)
    else:
        np.savez(path, video=frames)
    ours = video_io.read_video(path)
    assert isinstance(ours, np.memmap) == (ext == "npy")
    np.testing.assert_array_equal(ours, jax_video_io.read_video(path))
    np.testing.assert_array_equal(ours, frames)


def test_video_decoders_raise_without_ffmpeg(tmp_path, monkeypatch):
    """No ffprobe: probe_video raises; a container imageio cannot read
    either: read_video raises RuntimeError, as JAX's does."""
    path = str(tmp_path / "broken.mp4")
    with open(path, "wb") as f:
        f.write(b"not a video")
    for mod in (video_io, jax_video_io):
        monkeypatch.setattr(mod, "_ffmpeg_path", lambda: None)
        monkeypatch.setattr(mod, "_ffprobe_path", lambda: None)
        with pytest.raises(RuntimeError, match="ffprobe not available"):
            mod.probe_video(path)
        with pytest.raises(RuntimeError, match="cannot decode video"):
            mod.read_video(path)
    assert video_io.scaled_dims(320, 240) == jax_video_io.scaled_dims(320, 240) == (342, 256)


@pytest.fixture(scope="module")
def models(ckpt):
    """The audio ("mel256" API, tiny_L3 weights) and image models of both
    packages on one .ckpt."""
    return {
        "torch": (api.load_audio_embedding_model(ckpt(), model_type=TINY, device="cpu"),
                  api.ImageEmbeddingModel(ckpt(), model_type=TINY, device="cpu")),
        "jax": (jax_api.load_audio_embedding_model(ckpt(), model_type=TINY),
                jax_api.ImageEmbeddingModel(ckpt(), model_type=TINY)),
    }


def _same_npz(ours: str, theirs: str) -> None:
    """Same keys, shapes and timestamps exactly; embeddings at the gate."""
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].shape == b[k].shape, k
        if "timestamps" in a.files:
            np.testing.assert_array_equal(a["timestamps"], b["timestamps"])
        emb, jemb = a["embedding"], b["embedding"]
        assert _min_cos(np.atleast_2d(emb), np.atleast_2d(jemb)) >= 0.99999


def _dirs(tmp_path):
    ours, theirs = tmp_path / "torch", tmp_path / "jax"
    ours.mkdir()
    theirs.mkdir()
    return str(ours), str(theirs)


def _wav(tmp_path, seconds=1.3, sr=44100, seed=13):
    path = str(tmp_path / "clip.wav")
    rng = np.random.RandomState(seed)
    audio_io.write_wav(path, (rng.uniform(-0.4, 0.4, (int(seconds * sr), 2)) * 32767).astype(np.int16), sr)
    return path


def test_process_audio_file_matches_jax(tmp_path, models):
    """Same file name, keys, shapes and timestamps as JAX's
    process_audio_file, rows at the gate; overwrite=False leaves the file;
    a list gives a list."""
    wav = _wav(tmp_path)
    ours_dir, theirs_dir = _dirs(tmp_path)
    out = api.process_audio_file(wav, ours_dir, "tiny", model=models["torch"][0])
    jout = jax_api.process_audio_file(wav, theirs_dir, "tiny", model=models["jax"][0])
    assert os.path.basename(out) == os.path.basename(jout) == "clip_tiny.npz"
    _same_npz(out, jout)
    before = os.stat(out).st_mtime_ns
    assert api.process_audio_file(wav, ours_dir, "tiny", model=models["torch"][0], overwrite=False) == out
    assert os.stat(out).st_mtime_ns == before
    outs = api.process_audio_file([wav], ours_dir, model=models["torch"][0])
    assert outs == [os.path.join(ours_dir, "clip.npz")]


def test_process_image_file_matches_jax(tmp_path, models):
    """A .npy frame and a PNG: one 1-D vector each, under JAX's names, at
    the gate."""
    from PIL import Image

    rng = np.random.RandomState(14)
    npy, png = str(tmp_path / "img.npy"), str(tmp_path / "pic.png")
    np.save(npy, rng.randint(0, 256, (240, 320, 3), dtype=np.uint8))
    Image.fromarray(rng.randint(0, 256, (230, 250, 3), dtype=np.uint8)).save(png)
    ours_dir, theirs_dir = _dirs(tmp_path)
    outs = api.process_image_file([npy, png], ours_dir, model=models["torch"][1])
    jouts = jax_api.process_image_file([npy, png], theirs_dir, model=models["jax"][1])
    assert [os.path.basename(p) for p in outs] == [os.path.basename(p) for p in jouts] == ["img.npz", "pic.npz"]
    for o, j in zip(outs, jouts):
        with np.load(o) as data:
            assert data["embedding"].ndim == 1  # one image → one vector
        _same_npz(o, j)


def test_process_video_file_matches_jax(tmp_path, models):
    """An .npz video with frames, audio and fps gives both modalities' files
    (2 frames of 6 at 3 fps sampled at 1 fps); a bare .npy dump gives only
    the image file; names, keys, shapes and timestamps as JAX's."""
    rng = np.random.RandomState(15)
    video = str(tmp_path / "clip.npz")
    np.savez(video, video=rng.randint(0, 256, (6, 256, 300, 3), dtype=np.uint8),
             audio=(rng.uniform(-0.4, 0.4, 60000) * 32767).astype(np.int16), sr=48000, fps=3.0)
    frames = str(tmp_path / "frames.npy")
    np.save(frames, rng.randint(0, 256, (3, 256, 256, 3), dtype=np.uint8))
    ours_dir, theirs_dir = _dirs(tmp_path)
    kw = dict(audio_model=models["torch"][0], image_model=models["torch"][1])
    jkw = dict(audio_model=models["jax"][0], image_model=models["jax"][1])
    ours = api.process_video_file(video, ours_dir, **kw)
    theirs = jax_api.process_video_file(video, theirs_dir, **jkw)
    assert os.path.basename(ours["audio"]) == os.path.basename(theirs["audio"]) == "clip_audio.npz"
    assert os.path.basename(ours["image"]) == os.path.basename(theirs["image"]) == "clip_image.npz"
    for k in ("audio", "image"):
        _same_npz(ours[k], theirs[k])
    with np.load(ours["image"]) as data:
        np.testing.assert_array_equal(data["timestamps"], [0.0, 1.0])
    only = api.process_video_file(frames, ours_dir, source_fps=3.0, **kw)
    jonly = jax_api.process_video_file(frames, theirs_dir, source_fps=3.0, **jkw)
    assert only["audio"] is None and jonly["audio"] is None
    _same_npz(only["image"], jonly["image"])


@pytest.mark.parametrize("modality", ["audio", "image", "video"])
def test_main_matches_jax(tmp_path, ckpt, capsys, modality):
    """The CLI of both packages on one .ckpt: the same printed file names
    and the same files, the port with --device cpu."""
    rng = np.random.RandomState(16)
    if modality == "audio":
        path = _wav(tmp_path, seconds=1.1)
    elif modality == "image":
        path = str(tmp_path / "img.npy")
        np.save(path, rng.randint(0, 256, (224, 224, 3), dtype=np.uint8))
    else:
        path = str(tmp_path / "vid.npz")
        np.savez(path, video=rng.randint(0, 256, (2, 224, 224, 3), dtype=np.uint8),
                 audio=(rng.uniform(-0.4, 0.4, 50000) * 32767).astype(np.int16), sr=48000, fps=1.0)
    ours_dir, theirs_dir = _dirs(tmp_path)
    args = [path, "--modality", modality, "--weights-path", ckpt(), "--model-type", TINY, "--suffix", "cli"]
    assert api.main(args + ["--output-dir", ours_dir, "--device", "cpu"]) == 0
    ours = capsys.readouterr().out.split()
    assert jax_api.main(args + ["--output-dir", theirs_dir]) == 0
    theirs = capsys.readouterr().out.split()
    assert [os.path.basename(p) for p in ours] == [os.path.basename(p) for p in theirs] and ours
    for o, t in zip(ours, theirs):
        _same_npz(o, t)


def test_int8_artifact_raises(tmp_path):
    """int8_artifact= and --int8-artifact load int8 artifacts
    (tests/test_torch_port_int8.py holds a JAX-written one's rows against
    JAX's through both); an artifact that records no accuracy gate raises
    at the default gate, from the argument and from the flag, and nothing
    falls back to the f32 tower."""
    from l3embedding_torch.embed.quantized import IntEightAccuracyError, QuantizedEmbeddingExtractor

    ex = QuantizedEmbeddingExtractor(None, "cnn_L3_melspec1", "short", device="cpu")
    ex.q.calibrate(np.random.RandomState(3).uniform(-0.5, 0.5, (1, SR)).astype(np.float32))
    art = str(tmp_path / "ungated.npz")
    ex.save_artifact(art)
    with pytest.raises(IntEightAccuracyError, match="records no calibration cosine"):
        api.load_audio_embedding_model(int8_artifact=art, device="cpu")
    with pytest.raises(IntEightAccuracyError, match="records no calibration cosine"):
        api.main(["clip.wav", "--int8-artifact", art, "--device", "cpu"])


def test_cli_runs_as_a_module(tmp_path, ckpt):
    """python -m l3embedding_torch.api ... --device cpu writes and prints
    the npz path."""
    wav = _wav(tmp_path, seconds=1.0)
    proc = subprocess.run(
        [sys.executable, "-m", "l3embedding_torch.api", wav, "--model-type", TINY,
         "--weights-path", ckpt(), "--output-dir", str(tmp_path), "--device", "cpu"],
        capture_output=True, text=True, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = proc.stdout.split()
    assert out == [str(tmp_path / "clip.npz")]
    with np.load(out[0]) as data:
        assert data["embedding"].shape == (6, 350) and data["timestamps"].shape == (6,)
