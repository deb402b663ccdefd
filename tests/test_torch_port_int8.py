"""The port's int8 extraction (``l3embedding_torch/embed/quantized.py``, the
int8 conv's plain version, the int8-DFT front end, artifacts) against the
JAX package's ``embed/quantized.py`` on the CPU.

cnn_L3_melspec1 at full width (the int8 path refuses tiny_L3), one set of
seeded variables and one JAX-calibrated extractor shared by the module,
batches of at most 4 windows. Tolerances are stated at each check.
"""

import json
import os
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from l3embedding_tpu.embed import quantized as jq
from l3embedding_tpu.models import build_model as jax_build_model
from l3embedding_tpu.ops import frontend as jfe
from l3embedding_torch import api
from l3embedding_torch.data.audio_io import write_wav
from l3embedding_torch.embed import extract, http_serve
from l3embedding_torch.embed import quantized as tq
from l3embedding_torch.embed.extract import frame_uniform
from l3embedding_torch.ops import frontend as tfe
from l3embedding_torch.ops import int8_conv_kernel as ick
from torch_port_threads import one_torch_thread  # noqa: F401

MODEL = "cnn_L3_melspec1"
SR = 48000
GATE = 0.999


def _leaf(rng, path, shape):
    name = getattr(path[-1], "key", "")
    if name == "kernel":
        return rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[:-1]))
    if name == "scale":
        return 1.0 + 0.1 * rng.randn(*shape)
    if name == "var":
        return 1.0 + 0.3 * np.abs(rng.randn(*shape))
    return 0.05 * rng.randn(*shape)


def _variables(model_type=MODEL):
    """Seeded AVC variables (flax layout, numpy), without running flax's init."""
    model = jax_build_model(model_type).module()
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), np.zeros((1, 224, 224, 3), np.float32),
        np.zeros((1, 1, SR), np.float32), train=False))
    rng = np.random.RandomState(sum(map(ord, model_type)))
    return {k: jax.tree_util.tree_map_with_path(
        lambda p, s: _leaf(rng, p, s.shape).astype(np.float32), shapes[k])
        for k in ("params", "batch_stats")}


def _audio(n, seed=0, seconds=1.0):
    """Summed random tones + noise, each clip peak-normalised."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * SR)) / SR
    out = np.zeros((n, t.size), np.float32)
    for i in range(n):
        for _ in range(4):
            out[i] += rng.rand() * np.sin(2 * np.pi * rng.uniform(50, 8000) * t + rng.rand() * 6.28)
        out[i] += 0.1 * rng.randn(t.size)
        out[i] /= np.abs(out[i]).max() + 1e-9
    return out


def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1) + 1e-30)


@pytest.fixture(scope="module")
def variables():
    return _variables()


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    """Two 1.5 s clips: 4 windows at hop 0.5."""
    d = tmp_path_factory.mktemp("int8wavs")
    paths = []
    for i, clip in enumerate(_audio(2, seed=5, seconds=1.5)):
        paths.append(str(d / f"c{i}.wav"))
        write_wav(paths[-1], (clip * 32767 * 0.8).astype(np.int16), SR)
    return paths


def _windows(paths):
    from l3embedding_torch.data.audio_io import load_audio

    return np.concatenate([frame_uniform(load_audio(p, SR), SR, 0.5) for p in paths])


@pytest.fixture(scope="module")
def small_buckets():
    """Buckets of 2, 4 and 8 windows for the module: the full tower at the
    smallest production bucket (16) is 4x wasted work on the CPU."""
    old = extract.BUCKETS
    extract.BUCKETS = (2, 4, 8) + old
    yield
    extract.BUCKETS = old


@pytest.fixture(scope="module")
def jax_artifacts(variables, wavs, tmp_path_factory):
    """A JAX extractor calibrated on the 4 windows of the WAVs, its artifacts
    with the int8 DFT on and off, and its rows from each on the 2 windows of
    the first WAV (JAX's int8 conv runs ~9 s per 4 windows on the CPU). The
    gate it records is the min/mean cosine of those int8 rows against the
    port's folded f32 tower, whose fold equals JAX's (test_fold_equals_jax):
    JAX's own f32 reference would add a compile of ~10 s to the module."""
    ex = jq.QuantizedEmbeddingExtractor(None, MODEL, "short", variables=variables)
    ex.q.calibrate(_windows(wavs))
    windows = _windows(wavs[:1])
    rows = np.asarray(ex.q.embed_windows(windows))
    fold = tq.QuantizedAudioEmbedder(None, MODEL, "short", variables=variables, device="cpu").fold
    cos = _cos(rows, tq.folded_forward(fold, torch.from_numpy(windows), ex.q.pool).numpy())
    ex.calib_cosine = (float(cos.min()), float(cos.mean()))
    d = tmp_path_factory.mktemp("jaxart")
    out = {"ext": ex, "windows": windows}
    for dft in (True, False):
        ex.q.dft_int8 = dft
        path = str(d / f"jax_dft{int(dft)}.npz")
        ex.save_artifact(path)
        if not dft:
            rows = np.asarray(jq.QuantizedEmbeddingExtractor.load_artifact(path, min_cosine=None)
                              .q.embed_windows(windows))
        out[dft] = (path, rows)
    ex.q.dft_int8 = True
    return out


@pytest.fixture(scope="module")
def port_ext(variables, wavs, small_buckets):
    """The port's extractor on the CPU, calibrated (and gated) on the WAVs."""
    ex = tq.QuantizedEmbeddingExtractor(None, MODEL, "short", variables=variables, device="cpu")
    ex.calibrate_files(wavs, hop_size=0.5, min_cosine=None)
    return ex


def test_fold_equals_jax(variables):
    """Folded convs, biases and input BN equal JAX's fold_audio_tower (rtol
    1e-6: the same numpy ops in the same order); the int8 weights and their
    scales are equal byte for byte."""
    jqe = jq.QuantizedAudioEmbedder(None, MODEL, "short", variables=variables)
    tqe = tq.QuantizedAudioEmbedder(None, MODEL, "short", variables=variables, device="cpu")
    assert tqe.dft_int8 is True and tqe.fold.frontend_kind == "mel" and tqe.fold.n_mels == 128
    for (w, b), (tw, tb) in zip(jqe.fold.convs + [jqe.fold.emb_conv], tqe.fold.convs + [tqe.fold.emb_conv]):
        np.testing.assert_allclose(tw, w, rtol=1e-6, atol=0)
        np.testing.assert_allclose(tb, b, rtol=1e-6, atol=0)
    for a, ta in zip(jqe.fold.input_affine, tqe.fold.input_affine):
        np.testing.assert_allclose(ta, a, rtol=1e-6, atol=0)
    for wq, twq, ws, tws in zip(jqe._wq, tqe._wq, jqe._wscale, tqe._wscale):
        wq, ws = np.asarray(wq), np.asarray(ws)
        assert twq.dtype == wq.dtype == np.int8 and twq.tobytes() == wq.tobytes()
        assert tws.dtype == ws.dtype == np.float32 and tws.tobytes() == ws.tobytes()
        assert np.abs(twq).max() == 127


@pytest.mark.parametrize("cin", [1, 64, 128])
def test_int8_conv_plain_equals_jax_conv(cin):
    """The kernel's plain version: the int32 conv equals JAX's
    _conv(q, w, jnp.int32) bit for bit, and both epilogues equal JAX's
    formulas (quantized.py:394-407) on JAX's int32 output, bit for bit."""
    rng = np.random.RandomState(cin)
    x = rng.randint(-127, 128, (2, 6, 5, cin)).astype(np.int8)
    w = rng.randint(-127, 128, (3, 3, cin, 64)).astype(np.int8)
    deq = (rng.uniform(0.5, 1.5, 64) / (np.sqrt(9 * cin) * 127 * 73)).astype(np.float32)
    bias = (rng.randn(64) * 0.1).astype(np.float32)
    s_next = np.float32(2.5 / 127)
    z = jq._conv(jnp.asarray(x), jnp.asarray(w), jnp.int32)
    want_q = np.asarray(jnp.clip(jnp.round(jnp.maximum(z.astype(jnp.float32) * deq + bias, 0.0) / s_next),
                                 -127, 127).astype(jnp.int8))
    want_f = np.asarray(z.astype(jnp.float32) * deq + bias)
    xt, wp = torch.from_numpy(x), ick.pack_weights(w)
    assert wp.shape == (64, ick.padded_k(cin))
    acc = ick.conv3x3_s32_ref(xt, wp)
    assert acc.dtype == torch.int32 and np.array_equal(acc.numpy(), np.asarray(z))
    got_q = ick.conv3x3_s8(xt, wp, torch.from_numpy(deq), torch.from_numpy(bias), torch.tensor([s_next]))
    got_f = ick.conv3x3_s8(xt, wp, torch.from_numpy(deq), torch.from_numpy(bias))
    assert got_q.dtype == torch.int8 and np.array_equal(got_q.numpy(), want_q)
    assert got_f.dtype == torch.float32 and got_f.numpy().tobytes() == want_f.tobytes()
    assert not ick.LAUNCHES


@pytest.mark.parametrize("w", [5, 6])
def test_pooled_plain_conv_equals_jax_requant_then_reduce_window(w):
    """conv3x3_s8_ref(..., pool=True), the plain version of the kernel's
    pooled call, equals JAX's requant conv followed by its 2×2 VALID
    reduce_window (quantized.py:394-404) bit for bit, at an odd H with an
    odd W (the last row and column dropped) and with an even W."""
    rng = np.random.RandomState(w)
    x = np.maximum(rng.randint(-127, 128, (2, 7, w, 64)), 0).astype(np.int8)
    wq = rng.randint(-127, 128, (3, 3, 64, 64)).astype(np.int8)
    deq = (rng.uniform(0.5, 1.5, 64) / (np.sqrt(9 * 64) * 127 * 73)).astype(np.float32)
    bias = (rng.randn(64) * 0.1).astype(np.float32)
    s_next = np.float32(2.5 / 127)
    z = jq._conv(jnp.asarray(x), jnp.asarray(wq), jnp.int32)
    q = jnp.clip(jnp.round(jnp.maximum(z.astype(jnp.float32) * deq + bias, 0.0) / s_next), -127, 127)
    want = np.asarray(jax.lax.reduce_window(q.astype(jnp.int8), jnp.int8(-128), jax.lax.max,
                                            (1, 2, 2, 1), (1, 2, 2, 1), "VALID"))
    args = (torch.from_numpy(x), ick.pack_weights(wq), torch.from_numpy(deq), torch.from_numpy(bias),
            torch.tensor([s_next]))
    got = ick.conv3x3_s8(*args, pool=True)
    assert got.dtype == torch.int8 and got.shape == (2, 3, w // 2, 64) and np.array_equal(got.numpy(), want)
    assert torch.equal(ick.conv3x3_s8_ref(*args, pool=True), got)
    with pytest.raises(ValueError, match="pool follows the requant epilogue"):
        ick.conv3x3_s8(*args[:4], pool=True)


def test_quantized_tower_pooled_call_keeps_cpu_rows(port_ext, monkeypatch):
    """QuantizedTower takes blocks 1, 3 and 5 with the pool in the conv call;
    on the CPU its rows equal, bit for bit, those of the same tower with the
    conv unpooled and pool2_int8 after it (the forward before the pooled
    call)."""
    tower = port_ext.q.towers[0]
    x = torch.from_numpy(_audio(2, seed=4)[:, None, :])
    got = tower(x)
    calls = []

    def unpooled(q, w, deq, bias, s_next=None, pool=False):
        calls.append(pool)
        out = ick.conv3x3_s8(q, w, deq, bias, s_next)
        return ick.pool2_int8(out) if pool else out

    monkeypatch.setattr(tq, "conv3x3_s8", unpooled)
    want = tower(x)
    assert calls == [False, True, False, True, False, True, False, False]
    assert torch.equal(got, want)


def test_requant_epilogue_rounds_ties_like_jax():
    """Half-way cases made on purpose (every value exact in f32): round half
    to even, ReLU before the division, clip at ±127, equal to JAX's formula
    and to the values written out."""
    acc = np.array([0, 1, 2, 3, 4, 5, -1, -3, 125, 126, 127, 300], np.int32)
    deq = np.full(acc.size, 0.25, np.float32)
    bias = np.full(acc.size, 0.125, np.float32)
    s = np.float32(0.25)  # y / s = acc + 0.5 exactly
    expect = np.array([0, 2, 2, 4, 4, 6, 0, 0, 126, 126, 127, 127], np.int8)
    jax_q = np.asarray(jnp.clip(jnp.round(jnp.maximum(jnp.asarray(acc).astype(jnp.float32) * deq + bias, 0.0)
                                          / s), -127, 127).astype(jnp.int8))
    got = ick.requant_epilogue(torch.from_numpy(acc), torch.from_numpy(deq), torch.from_numpy(bias),
                               torch.tensor([s])).numpy()
    assert np.array_equal(jax_q, expect) and np.array_equal(got, expect)
    with pytest.raises(ValueError, match="multiple of 64"):
        ick.conv3x3_s8(torch.zeros(1, 2, 2, 1, dtype=torch.int8), torch.zeros(32, 64, dtype=torch.int8),
                       torch.zeros(32), torch.zeros(32))


def test_int8dft_frontend_equals_jax():
    """melspectrogram_int8dft: the quantized waveform and the int32 DFT
    product equal JAX's exactly (n_dft-wide frames against JAX's chunked
    2178-wide frames padded to 2304); the dB features within 1e-3 dB."""
    rng = np.random.RandomState(3)
    x = (rng.randn(2, SR) * rng.uniform(0.05, 0.5, (2, 1))).astype(np.float32)
    cfg = tfe.MelConfig(n_mels=256)
    xq, s = tfe.quantize_waveform(torch.from_numpy(x))
    js = jnp.maximum(jnp.max(jnp.abs(x), axis=-1, keepdims=True), 1e-6) / 127.0
    jxq = jnp.clip(jnp.round(x / js), -127, 127).astype(jnp.int8)
    assert np.array_equal(xq.numpy(), np.asarray(jxq)) and np.array_equal(s.numpy(), np.asarray(js))

    ext = jfe.frame_signal_chunked(jxq, cfg.n_dft, cfg.hop, cfg.padding)
    width = -(-ext.shape[-1] // 256) * 256
    assert (ext.shape[-1], width) == (2178, 2304)
    ext = jnp.concatenate([ext, jnp.zeros(ext.shape[:-1] + (width - ext.shape[-1],), jnp.int8)], -1)
    bank, c = jfe._stft_basis_int8(cfg.n_dft, None, width)
    want = np.asarray(jnp.matmul(ext, jnp.asarray(bank), preferred_element_type=jnp.int32))

    tbank, tc = tfe.stft_basis_int8(cfg.n_dft)
    assert np.array_equal(tbank, bank[: cfg.n_dft]) and not bank[cfg.n_dft:].any()
    assert np.array_equal(tc, c)
    frames = tfe.frame_signal(xq, cfg.n_dft, cfg.hop, cfg.padding).reshape(-1, cfg.n_dft)
    bank_t, _ = tfe.int8_bank_device(cfg.n_dft, "cpu")
    assert bank_t.shape == (2056, 2048)
    got = tfe.int8_dft_product(frames, bank_t)
    assert got.dtype == torch.int32 and not got[:, 2050:].any()
    assert np.array_equal(got[:, :2050].numpy().reshape(want.shape), want)

    feats = tfe.melspectrogram_int8dft(torch.from_numpy(x), cfg).numpy()
    jfeats = np.asarray(jfe.melspectrogram_int8dft(jnp.asarray(x), jfe.MelConfig(n_mels=256)))
    assert feats.shape == jfeats.shape == (2, 256, 199, 1)
    assert np.abs(feats - jfeats).max() < 1e-3


def test_calibration_scales_near_jax(variables):
    """Calibration (amax) on the bf16 front end, as JAX's: scales within
    2e-3 relative of JAX's. The port's bf16 front end keeps the mel product
    in f32 where JAX rounds its operands to bf16 (ROADMAP Queue 3), which
    moves the first scale by ~1e-4."""
    cal = _audio(3, seed=2)
    jqe = jq.QuantizedAudioEmbedder(None, MODEL, "short", variables=variables)
    tqe = tq.QuantizedAudioEmbedder(None, MODEL, "short", variables=variables, device="cpu")
    np.testing.assert_allclose(tqe.calibrate(cal), np.asarray(jqe.calibrate(cal)), rtol=2e-3)
    np.testing.assert_allclose(tqe._act_scales, np.asarray(jqe._act_scales), rtol=2e-3)
    assert tqe._act_scales.dtype == np.float32 and tqe._act_scales.shape == (8,)


def test_percentile_calibration(variables):
    """The percentile (numpy's and JAX's linear interpolation, from a top-k
    instead of a sort) equals np.percentile; percentile scales lie at or
    below the amax scales and the tower keeps the 0.999 gate."""
    x = torch.from_numpy(np.random.RandomState(1).randn(10001).astype(np.float32))
    for p in (0.0, 12.5, 50.0, 99.9, 99.99, 100.0):
        np.testing.assert_allclose(tq.percentile(x, p).item(), np.percentile(x.numpy(), p), rtol=1e-6)
    q = tq.QuantizedAudioEmbedder(None, MODEL, "short", variables=variables, device="cpu")
    cal = _audio(2, seed=2)
    amax = np.maximum(q.calibrate(cal), 1e-12) / 127.0
    q.calibrate(cal, method="percentile", percentile=99.99)
    assert (q._act_scales <= amax * (1 + 1e-6)).all() and (q._act_scales > 0).all()
    assert q.embedding_cosine(_audio(2, seed=9))[0] >= GATE
    with pytest.raises(ValueError, match="method"):
        q.calibrate(cal, method="entropy")


@pytest.mark.parametrize("dft_int8", [True, False])
def test_jax_artifact_rows_in_port(jax_artifacts, small_buckets, dft_int8):
    """A JAX-written artifact loaded in the port gives JAX's int8 rows at
    per-row cosine >= 0.999 (the int8 gate), with the int8 DFT on and off."""
    path, want = jax_artifacts[dft_int8]
    ex = tq.QuantizedEmbeddingExtractor.load_artifact(path, min_cosine=None, device="cpu")
    assert ex.q.dft_int8 is dft_int8 and ex.model_type == MODEL and ex.pooling_type == "short"
    got = ex.embed_windows(jax_artifacts["windows"])
    assert got.shape == want.shape == (2, 512) and np.isfinite(got).all()
    assert _cos(got, want).min() >= GATE


@pytest.mark.parametrize("dft_int8", [True, False])
def test_port_int8_against_port_folded_f32(variables, port_ext, dft_int8):
    """The port's int8 rows against its own folded f32 tower: min cosine >=
    0.999 with the int8 DFT on and off (the same scales)."""
    q = tq.QuantizedAudioEmbedder(None, MODEL, "short", variables=variables, device="cpu", dft_int8=dft_int8)
    q._set_scales(port_ext.q._act_scales)
    cmin, cmean = q.embedding_cosine(_audio(2, seed=3))
    assert cmin >= GATE and cmin <= cmean <= 1.0 + 1e-6


def test_artifacts_round_trip_between_packages(jax_artifacts, port_ext, tmp_path):
    """A JAX artifact loaded and saved again by the port is the same npz
    (names, dtypes, bytes, meta); a port artifact loads in JAX with every
    array and the meta intact. An artifact without the dft_int8 key loads
    with the bf16 front end."""
    path, _ = jax_artifacts[True]
    again = str(tmp_path / "again.npz")
    ex = tq.QuantizedEmbeddingExtractor.load_artifact(path, min_cosine=None, device="cpu")
    ex.save_artifact(again)
    with np.load(path) as a, np.load(again) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            if k != "meta_json":
                assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
        assert json.loads(a["meta_json"].tobytes()) == json.loads(b["meta_json"].tobytes())

    ours = str(tmp_path / "port.npz")
    port_ext.save_artifact(ours)
    loaded = jq.QuantizedEmbeddingExtractor.load_artifact(ours, min_cosine=None)
    assert (loaded.model_type, loaded.pooling_type, loaded.q.dft_int8) == (MODEL, "short", True)
    assert loaded.calib_cosine == pytest.approx(port_ext.calib_cosine)
    for i in range(8):
        assert np.asarray(loaded.q._wq[i]).tobytes() == port_ext.q._wq[i].tobytes()
        assert np.asarray(loaded.q._wscale[i]).tobytes() == port_ext.q._wscale[i].tobytes()
        assert np.asarray(loaded.q._biases[i]).tobytes() == port_ext.q._biases[i].tobytes()
    assert np.asarray(loaded.q._act_scales).tobytes() == port_ext.q._act_scales.tobytes()

    old = str(tmp_path / "old.npz")
    with np.load(ours) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(arrays["meta_json"].tobytes())
    del meta["dft_int8"]
    arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(old, **arrays)
    assert tq.QuantizedEmbeddingExtractor.load_artifact(old, min_cosine=None, device="cpu").q.dft_int8 is False


def test_calibrate_files_measures_and_gates(port_ext, wavs):
    """calibrate_files records the measured cosine, raises
    IntEightAccuracyError at min_cosine=1.0, and min_cosine=None turns the
    gate off (the scales and cosine recorded again)."""
    cmin, cmean = port_ext.calib_cosine
    assert GATE <= cmin <= cmean <= 1.0 + 1e-6
    scales, recorded = port_ext.q._act_scales, port_ext.calib_cosine
    try:
        with pytest.raises(tq.IntEightAccuracyError, match="min cosine"):
            port_ext.calibrate_files(wavs[:1], hop_size=0.5, min_cosine=1.0)
        assert port_ext.calibrate_files(wavs[:1], hop_size=0.5, min_cosine=None) == port_ext.calib_cosine
        assert port_ext.calib_cosine != recorded and port_ext.calib_cosine[0] >= GATE
    finally:
        port_ext.q._set_scales(scales)
        port_ext.calib_cosine = recorded


def test_artifact_gate_and_reference_tower(port_ext, wavs, tmp_path):
    """Saved and loaded: identical rows; the recorded gate is enforced at
    load; an artifact-loaded tower refuses to recalibrate or regate; a file
    that is not an artifact is refused."""
    art = str(tmp_path / "tower.int8.npz")
    port_ext.save_artifact(art)
    loaded = tq.QuantizedEmbeddingExtractor.load_artifact(art, min_cosine=port_ext.calib_cosine[0] - 1e-6,
                                                          device="cpu")
    w = _audio(2, seed=11)
    assert np.array_equal(loaded.embed_windows(w), port_ext.embed_windows(w))
    with pytest.raises(tq.IntEightAccuracyError, match="recorded min cosine"):
        tq.QuantizedEmbeddingExtractor.load_artifact(art, min_cosine=1.0, device="cpu")
    with pytest.raises(RuntimeError, match="reference tower"):
        loaded.q.embedding_cosine(w)
    with pytest.raises(RuntimeError, match="reference tower"):
        loaded.calibrate_files(wavs)
    bogus = str(tmp_path / "bogus.npz")
    np.savez(bogus, x=np.zeros(3))
    with pytest.raises((ValueError, KeyError)):
        tq.QuantizedEmbeddingExtractor.load_artifact(bogus, device="cpu")


def test_device_framing_matches_host_framing(port_ext):
    """Windows cut on the device equal host framing: hop-aligned, a dropped
    non-aligned tail, and a clip shorter than a window (host path)."""
    rng = np.random.RandomState(6)
    for length in (int(1.5 * SR), int(1.5 * SR) + 777, SR // 3):
        audio = (rng.randn(length) * 0.1).astype(np.float32)
        got = port_ext.embed_audio(audio, hop_size=0.5, device_framing=True)
        want = port_ext.embed_audio(audio, hop_size=0.5, device_framing=False)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_devices_split_matches_one_device(variables, port_ext):
    """devices=['cpu', 'cpu'] (the JAX mesh): towers on each, the batch split
    (3 windows pad to 4; the extractor's bucket of 2 splits in 1 + 1), the
    same rows as one device."""
    q = tq.QuantizedAudioEmbedder(None, MODEL, "short", variables=variables, devices=["cpu", "cpu"])
    assert len(q.towers) == 2
    q._set_scales(port_ext.q._act_scales)
    w = _audio(3, seed=4)
    want = port_ext.q.embed_windows(w)
    np.testing.assert_allclose(q.embed_windows(w), want, rtol=1e-5, atol=1e-6)
    ex = tq.QuantizedEmbeddingExtractor(None, MODEL, "short", variables=variables, devices=["cpu", "cpu"])
    ex.q._set_scales(port_ext.q._act_scales)
    np.testing.assert_allclose(ex.embed_windows(w[:2]), want[:2], rtol=1e-5, atol=1e-6)


def test_tiny_refused():
    with pytest.raises(ValueError, match="int8 quantization supports the full L3 audio towers; "
                                         "'tiny_L3' uses TinyL3AudioTower"):
        tq.QuantizedAudioEmbedder(None, "tiny_L3", device="cpu")


def test_dft_int8_on_a_linear_type_refused():
    q = tq.QuantizedAudioEmbedder(None, "cnn_L3_orig", device="cpu")
    assert q.dft_int8 is False
    q = tq.QuantizedAudioEmbedder(None, "cnn_L3_orig", device="cpu", dft_int8=True)
    q._set_scales(np.ones(8, np.float32))
    with pytest.raises(ValueError, match="mel front-ends"):
        q.embed_windows(_audio(1, seed=3))


def test_embed_requires_calibration(variables):
    q = tq.QuantizedAudioEmbedder(None, MODEL, "short", variables=variables, device="cpu")
    with pytest.raises(RuntimeError, match="calibrate"):
        q.embed_windows(_audio(1))
    ex = tq.QuantizedEmbeddingExtractor(None, MODEL, "short", variables=variables, device="cpu")
    with pytest.raises(RuntimeError, match="calibrate_files"):
        ex.embed_audio(np.zeros(2 * SR, np.float32))


def test_api_loads_a_jax_artifact(jax_artifacts, wavs, small_buckets, tmp_path, capsys):
    """load_audio_embedding_model(int8_artifact=...) and the CLI's
    --int8-artifact load a JAX-written artifact (its recorded gate checked
    at 0.999) and give JAX's rows at the int8 gate (the same windows:
    reference framing, and the CLI without centering)."""
    from l3embedding_torch.data.audio_io import load_audio

    path, want = jax_artifacts[True]
    assert jax_artifacts["ext"].calib_cosine[0] >= GATE
    model = api.load_audio_embedding_model(int8_artifact=path, device="cpu")
    assert isinstance(model, tq.QuantizedEmbeddingExtractor) and model.q.dft_int8 is True
    got, ts = api.get_audio_embedding(load_audio(wavs[0], SR), SR, model=model, hop_size=0.5,
                                      reference_framing=True)
    assert got.shape == want.shape == (2, 512) and ts.shape == (2,)
    assert _cos(got, want).min() >= GATE
    assert api.main([wavs[0], "--int8-artifact", path, "--hop-size", "0.5", "--no-centering",
                     "--output-dir", str(tmp_path), "--device", "cpu"]) == 0
    with np.load(capsys.readouterr().out.split()[0]) as z:
        emb = z["embedding"]
    assert emb.shape == (2, 512) and _cos(emb, want).min() >= GATE


def test_http_serves_int8(variables, wavs, small_buckets, tmp_path):
    """http_serve's --int8 flags on the CPU (as tests/test_quantized.py's
    test_http_serving_int8): --int8 --int8-calib calibrates and
    --int8-save-artifact writes an artifact; --int8-artifact serves it, and
    /healthz and /v1/embed answer with the artifact's rows."""
    from l3embedding_tpu.training.checkpoints import save_variables

    ckpt = str(tmp_path / "m.ckpt")
    save_variables(ckpt, variables["params"], variables["batch_stats"])
    art = str(tmp_path / "served.npz")
    built = http_serve.build_extractor(http_serve.parse_args([
        ckpt, "--model-type", MODEL, "--int8", "--int8-calib", os.path.dirname(wavs[0]),
        "--int8-min-cosine", "0", "--int8-save-artifact", art, "--device", "cpu"]))
    assert isinstance(built, tq.QuantizedEmbeddingExtractor) and os.path.exists(art)
    ex = http_serve.build_extractor(http_serve.parse_args(
        ["--int8-artifact", art, "--int8-min-cosine", "0", "--device", "cpu"]))
    srv = http_serve.make_server(ex, host="127.0.0.1", port=0, max_latency_ms=20)
    http_serve.serve_forever_in_thread(srv)
    try:
        host, port = srv.server_address
        with urllib.request.urlopen(f"http://{host}:{port}/healthz") as r:
            body = json.load(r)
        assert body["model_type"] == MODEL and body["dim"] == 512
        clip = _audio(1, seed=7)[0]
        req = urllib.request.Request(
            f"http://{host}:{port}/v1/embed",
            data=json.dumps({"audio": clip.tolist(), "sr": SR}).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=600) as r:
            out = json.load(r)
        emb = np.asarray(out["embeddings"], np.float32)
        assert out["dim"] == 512 and np.isfinite(emb).all()
        np.testing.assert_allclose(emb, built.embed_windows(clip[None]), rtol=1e-5, atol=1e-6)
    finally:
        srv.shutdown()
        srv.l3_service.close()
        srv.server_close()
