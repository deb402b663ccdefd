"""The host side of the bf16 front-end kernels' DFT stage
(``csrc/dft_stage.cuh``, ``l3embedding_torch/ops/dft_stage.py``), checked
on the CPU.

The basis stages are read back through the ``wgmma`` descriptor's address
rule, the mel filterbank's chunk-cut segments are expanded back to the
filterbank, and a numpy model of the kernels' schedule (bf16 operands,
interleaved re/im pairs, pair 0 unpacked into bins 0 and N/2, the power
tile of each 64-bin chunk, the segment sums with their carry) is held
against the plain versions and the JAX package's Pallas kernels in
interpret mode. An index error in the layout or the schedule shows here,
before the kernel runs on a card.
"""

import numpy as np
import pytest
import torch

from l3embedding_tpu.ops import dsp_ref as jdsp
from l3embedding_tpu.ops import frontend as jfe
from l3embedding_tpu.ops.pallas_frontend import melspectrogram_fused as jax_mel_fused
from l3embedding_tpu.ops.pallas_frontend import spectrogram_fused as jax_spec_fused
from l3embedding_torch.ops import dft_stage, fft_stage, mel_kernel, spec_kernel
from l3embedding_torch.ops import frontend as tfe

SPEC_CONFIGS = {
    "orig": {},
    "kapredbinputbn": {"decibel": True},
    "tiny": {"n_dft": 512, "hop": 240, "n_win": 480, "decibel": True},
}


def _pcm(seed, batch=2, n=48000, scale=0.3):
    x = (np.random.RandomState(seed).randn(batch, n) * scale).astype(np.float32)
    x *= np.float32(10.0) ** np.linspace(0, -1, batch, dtype=np.float32)[:, None]
    x[:, 10000:30000] = 0.0  # a silent stretch
    return x


def _gate(ours, theirs, cos_gate=0.9999, mean_gate=0.1):
    """Per-sample cosine > cos_gate and mean |Δ| < mean_gate (dB): the bf16
    gate."""
    ours, theirs = np.asarray(ours, np.float64), np.asarray(theirs, np.float64)
    assert ours.shape == theirs.shape
    for a, b in zip(ours, theirs):
        u, v = a.ravel(), b.ravel()
        assert (u @ v) / (np.linalg.norm(u) * np.linalg.norm(v)) > cos_gate
    assert np.abs(ours - theirs).mean() < mean_gate


def _db(x):
    return jdsp.amplitude_to_db(np.asarray(x, np.float64), sample_axes=(1, 2))


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16).float().numpy()


# --- the model of the bf16 kernels' schedule -------------------------------


def _power_tiles(x, n_dft, hop, padding, n_win=None):
    """Yield (chunk, P) with P (B, T, 65) f32 the kernel's power tile after
    the chunk: rows 0-63 the chunk's bins, row 64 bin N/2 from chunk 0's
    pair 0 when packed (no later chunk writes it)."""
    frames = _bf16(tfe.frame_signal(torch.from_numpy(x), n_dft, hop, padding).numpy())
    cols = _bf16(dft_stage.interleaved(*tfe.stft_basis_f32(n_dft, n_win)))
    s = np.einsum("btk,nk->btn", frames, cols, dtype=np.float32)
    tile = np.zeros(s.shape[:2] + (dft_stage.BINS_PER_CHUNK + 1,), np.float32)
    for c in range(cols.shape[0] // dft_stage.COLS_PER_CHUNK):
        d = s[..., c * dft_stage.COLS_PER_CHUNK : (c + 1) * dft_stage.COLS_PER_CHUNK]
        re, im = d[..., 0::2], d[..., 1::2]
        tile[..., :64] = re * re + im * im
        if c == 0 and dft_stage.packed(n_dft):
            tile[..., 0] = re[..., 0] * re[..., 0]
            tile[..., 64] = im[..., 0] * im[..., 0]
        yield c, tile


def _mel_model(x, cfg):
    ptr, lo, w = fft_stage.mel_csr(cfg.sr, cfg.n_dft, cfg.n_mels, cfg.fmin, cfg.fmax, cfg.htk)
    seg_ptr, segs = dft_stage.mel_segments(ptr, lo, cfg.n_dft)
    carry, mel = {}, None
    for c, tile in _power_tiles(x, cfg.n_dft, cfg.hop, cfg.padding):
        if mel is None:
            mel = np.full(tile.shape[:2] + (cfg.n_mels,), np.nan, np.float32)
        for head, row, length, off in segs[seg_ptr[c] : seg_ptr[c + 1]]:
            m, slot, flags = head & 0xFFFF, (head >> 16) & 0xFF, head >> 24
            acc = carry.pop(slot) if flags & dft_stage.SEG_FROM else np.zeros(tile.shape[:2], np.float32)
            for j in range(length):
                acc = acc + w[off + j] * tile[..., row + j]
            if flags & dft_stage.SEG_TO:
                carry[slot] = acc
            else:
                mel[..., m] = acc
    assert not carry and not np.isnan(mel).any()
    return tfe.to_nhwc_db(torch.sqrt(torch.from_numpy(mel).clamp(min=0.0)), cfg).numpy()


def _spec_model(x, cfg):
    out = None
    for c, tile in _power_tiles(x, cfg.n_dft, cfg.hop, cfg.padding, cfg.n_win):
        if out is None:
            out = np.full(tile.shape[:2] + (cfg.n_freq,), np.nan, np.float32)
        rows = 65 if c == 0 and dft_stage.packed(cfg.n_dft) else 64
        for i in range(rows):
            b = c * 64 + i if i < 64 else cfg.n_dft // 2
            if b < cfg.n_freq:
                out[..., b] = tile[..., i]
    assert not np.isnan(out).any()
    return tfe.to_nhwc_db(spec_kernel._power(torch.from_numpy(out), cfg.power), cfg).numpy()


# --- tests -------------------------------------------------------------------


@pytest.mark.parametrize("n_dft", [512, 576, 1024, 2048])
def test_interleaved_columns_unpack_to_the_bases(n_dft):
    """re_f and im_f at columns 2f, 2f+1; packed (n_dft a multiple of 128)
    pair 0 is (re_0, re_{N/2}) and the columns are exactly n_dft, else bin
    N/2 takes the pair after n_dft and zeros fill the last chunk; the
    dropped values are im_0 (exactly −0.0) and im_{N/2} (< 5e-13)."""
    real, imag = tfe.stft_basis_f32(n_dft)
    w = dft_stage.interleaved(real, imag)
    packed = n_dft % 128 == 0
    assert packed == dft_stage.packed(n_dft)
    assert w.shape == ((n_dft if packed else n_dft + 64), n_dft)
    got_re, got_im = dft_stage.unpack_pairs(w)
    np.testing.assert_array_equal(got_re, real)
    np.testing.assert_array_equal(got_im[:, 1:-1], imag[:, 1:-1])
    assert not imag[:, 0].any() and np.abs(imag[:, -1]).max() < 5e-13
    if packed:
        assert not got_im[:, -1].any()
    else:
        np.testing.assert_array_equal(got_im[:, -1], imag[:, -1])
        assert not w[n_dft + 2 :].any()


@pytest.mark.parametrize("n_dft", [512, 576, 2048])
def test_stage_tiles_read_through_the_descriptor(n_dft):
    """Every (column, k) of every stage, read at the address the wgmma B
    descriptor gives (K step start + 32 bytes a step, SBO 1024, 128-byte
    rows, 128-byte swizzle), is the plain column's value; the stage is a
    permutation of its 128 × 64 values."""
    w = dft_stage.interleaved(*tfe.stft_basis_f32(n_dft))
    tiles = dft_stage.stage_tiles(w)
    n_chunks, n_kt = w.shape[0] // 128, n_dft // 64
    assert tiles.shape == (n_chunks, n_kt, 128 * 64)
    n, k = np.meshgrid(np.arange(128), np.arange(64), indexing="ij")
    offsets = np.vectorize(dft_stage.descriptor_offset)(n, k)
    assert offsets.min() == 0 and offsets.max() == 2 * (128 * 64 - 1)
    assert np.unique(offsets).size == 128 * 64 and (offsets % 2 == 0).all()
    np.testing.assert_array_equal(offsets, 2 * dft_stage.swizzle_index(n, k))
    for c in range(n_chunks):
        for kt in range(n_kt):
            plain = w[c * 128 : (c + 1) * 128, kt * 64 : (kt + 1) * 64]
            np.testing.assert_array_equal(tiles[c, kt][offsets // 2], plain)


def test_device_bases_are_the_bf16_bits_of_the_pallas_bases():
    """The device bases, rounded once to bf16 (RNE), hold the Pallas
    kernels' bf16 bases for the spectrogram's 512 with a 480 window."""
    from l3embedding_tpu.ops.pallas_frontend import _padded_stft_bases

    wt = dft_stage.device_bases(512, 480, "cpu")
    assert wt.dtype == torch.bfloat16 and wt.shape == (4, 8, 8192)
    n, k = np.meshgrid(np.arange(128), np.arange(64), indexing="ij")
    idx = dft_stage.swizzle_index(n, k)
    cols = np.concatenate(
        [np.concatenate([wt[c, kt].float().numpy()[idx] for kt in range(8)], axis=1) for c in range(4)]
    )
    real, imag = dft_stage.unpack_pairs(cols)
    j_re, j_im, _ = _padded_stft_bases(512, 480)
    np.testing.assert_array_equal(real, np.asarray(j_re[:, :257], np.float32))
    np.testing.assert_array_equal(imag[:, :256], np.asarray(j_im[:, :256], np.float32))


@pytest.mark.parametrize("n_dft", [512, 576, 1024, 2048])
@pytest.mark.parametrize("n_mels", [256, 128])
def test_mel_segments_expand_to_the_filterbank(n_mels, n_dft):
    """The segments give back mel_matrix_f32 (bin N/2 read at row 64 of the
    last chunk when packed); a filter carried out of a chunk is taken up in
    the next one from the same slot, a slot freed in a chunk is not taken
    again in it, and every filter is finished exactly once. At n_dft 2048
    no filter spans more than two chunks."""
    key = (48000, n_dft, n_mels, 0.0, None, True)
    ptr, lo, w = fft_stage.mel_csr(*key)
    seg_ptr, segs = dft_stage.mel_segments(ptr, lo, n_dft)
    n_chunks = seg_ptr.size - 1
    assert n_chunks == dft_stage.round_up(n_dft + (0 if n_dft % 128 == 0 else 2), 128) // 128
    assert seg_ptr[-1] == len(segs) and segs.dtype == np.int32
    dense = tfe.mel_matrix_f32(*key) + np.float32(0.0)
    expanded = np.zeros_like(dense)
    finished, open_slots, chunks_of = [], {}, {}
    for c in range(n_chunks):
        freed, taken = set(), set()
        for head, row, length, off in segs[seg_ptr[c] : seg_ptr[c + 1]]:
            m, slot, flags = head & 0xFFFF, (head >> 16) & 0xFF, head >> 24
            chunks_of.setdefault(m, set()).add(c)
            if flags & dft_stage.SEG_FROM:
                assert open_slots.pop(slot) == (m, c - 1)
                freed.add(slot)
            if flags & dft_stage.SEG_TO:
                assert slot not in open_slots and slot < dft_stage.MAX_SLOTS
                taken.add(slot)
                open_slots[slot] = (m, c)
            else:
                finished.append(m)
            for j in range(length):
                r = row + j
                b = n_dft // 2 if r == 64 else c * 64 + r
                assert r < 64 or (dft_stage.packed(n_dft) and c == n_chunks - 1)
                expanded[b, m] = w[off + j]
        assert not (freed & taken)
    assert not open_slots and sorted(finished) == list(range(n_mels))
    np.testing.assert_array_equal(expanded.view(np.uint32), dense.view(np.uint32))
    if n_dft == 2048:
        assert max(len(v) for v in chunks_of.values()) <= 2


@pytest.mark.parametrize("decibel", [True, False])
@pytest.mark.parametrize("n_mels", [256, 128])
def test_mel_model_matches_plain_version_and_pallas(n_mels, decibel):
    """The model of the bf16 mel kernel vs melspectrogram_fused_ref(fast=True)
    and JAX's melspectrogram_fused(interpret=True), on clips with a silent
    stretch: cosine > 0.9999, mean |Δ| < 0.1 dB (amplitude compared after
    the same per-sample dB)."""
    x = _pcm(30)
    cfg = tfe.MelConfig(n_mels=n_mels, decibel=decibel)
    ours = _mel_model(x, cfg)
    plain = mel_kernel.melspectrogram_fused_ref(torch.from_numpy(x), cfg, fast=True).numpy()
    pallas = np.asarray(jax_mel_fused(x, jfe.MelConfig(n_mels=n_mels, decibel=decibel), interpret=True))
    assert ours.shape == plain.shape == pallas.shape == (2, n_mels, 199, 1)
    if not decibel:
        ours, plain, pallas = _db(ours), _db(plain), _db(pallas)
    _gate(ours, plain)
    _gate(ours, pallas)


@pytest.mark.parametrize("n_dft", [576, 1024])
def test_mel_model_at_other_frame_sizes(n_dft):
    """The unpacked layout (576: bin N/2 after the last pair) and a second
    packed size against the plain version, 128 mels, an odd length."""
    x = _pcm(31, n=23999)
    cfg = tfe.MelConfig(n_dft=n_dft, n_mels=128)
    ours = _mel_model(x, cfg)
    plain = mel_kernel.melspectrogram_fused_ref(torch.from_numpy(x), cfg, fast=True).numpy()
    assert ours.shape == plain.shape == (2, 128, cfg.n_frames(23999), 1)
    _gate(ours, plain)


@pytest.mark.parametrize("name", sorted(SPEC_CONFIGS))
def test_spec_model_matches_plain_version_and_pallas(name):
    """The model of the bf16 spectrogram kernel (bin 256 out of pair 0) vs
    spectrogram_fused_ref(fast=True) and JAX's spectrogram_fused(interpret=
    True) in the three configurations: cosine > 0.9999, mean |Δ| < 0.1 dB
    (amplitude compared after the same per-sample dB)."""
    x = _pcm(32)
    kw = SPEC_CONFIGS[name]
    tcfg, jcfg = tfe.SpectrogramConfig(**kw), jfe.SpectrogramConfig(**kw)
    ours = _spec_model(x, tcfg)
    plain = spec_kernel.spectrogram_fused_ref(torch.from_numpy(x), tcfg, fast=True).numpy()
    pallas = np.asarray(jax_spec_fused(x, jcfg, interpret=True))
    assert ours.shape == plain.shape == pallas.shape
    if not tcfg.decibel:
        ours, plain, pallas = _db(ours), _db(plain), _db(pallas)
    _gate(ours, plain)
    _gate(ours, pallas)


def test_spec_model_unpacked_keeps_bin_n_over_2():
    """n_dft 576 (not a chunk multiple): bin 288 comes from the pair after
    n_dft; the model matches the plain version, power 2 and dB."""
    x = _pcm(33, n=12000)
    cfg = tfe.SpectrogramConfig(n_dft=576, hop=240, power=2.0, decibel=True)
    ours = _spec_model(x, cfg)
    plain = spec_kernel.spectrogram_fused_ref(torch.from_numpy(x), cfg, fast=True).numpy()
    assert ours.shape == plain.shape == (2, 289, cfg.n_frames(12000), 1)
    _gate(ours, plain)


@pytest.mark.parametrize("n_dft", [100, 1000, 2047])
def test_bf16_n_dft_check_rejects(n_dft):
    with pytest.raises(ValueError, match="multiple of 64"):
        dft_stage.check_n_dft(n_dft, "test")


# --- on the card -------------------------------------------------------------


def _card_pcm(seed, batch, n):
    """Rows at gains from 0.01 to 1, the first with a silent stretch."""
    rng = np.random.RandomState(seed)
    pcm = (rng.randn(batch, n) * 0.3 * rng.uniform(0.01, 1.0, (batch, 1))).astype(np.float32)
    pcm[0, 10000:30000] = 0.0
    return pcm


def _with_frames(monkeypatch, frames):
    """Run the bf16 kernels at `frames` frames per block."""
    monkeypatch.setattr(dft_stage, "frames_per_block", lambda *_: frames)
    mel_kernel._launch.cache_clear()
    spec_kernel._launch.cache_clear()


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 8, 64])
@pytest.mark.parametrize("n_mels", [256, 128])
@pytest.mark.parametrize("n_dft", [512, 576, 1024, 2048])
def test_cuda_bf16_mel_kernel_matches_plain_version(n_dft, n_mels, batch, monkeypatch):
    """On the card: the wgmma mel kernel vs its plain version at packed
    (512, 1024, 2048) and unpacked (576) frame sizes, both widths, B = 1, 8
    and 64, an odd length with a silent stretch (cosine > 0.9999, mean
    |Δ| < 0.1 dB)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    x = torch.from_numpy(_card_pcm(40, batch, 47999)).cuda()
    cfg = tfe.MelConfig(n_dft=n_dft, n_mels=n_mels)
    mel_kernel.LAUNCHES.clear()
    got = mel_kernel.melspectrogram_fused(x, cfg, fast=True).cpu().numpy()
    assert mel_kernel.LAUNCHES["bf16"] == 1
    want = mel_kernel.melspectrogram_fused_ref(x, cfg, fast=True).cpu().numpy()
    assert got.shape == want.shape == (batch, n_mels, cfg.n_frames(47999), 1)
    assert np.isfinite(got).all()
    _gate(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 8, 64])
@pytest.mark.parametrize("n_dft", [512, 576, 1024, 2048])
def test_cuda_bf16_spec_kernel_matches_plain_version(n_dft, batch, monkeypatch):
    """On the card: the wgmma spectrogram kernel vs its plain version, dB,
    at packed and unpacked frame sizes, B = 1, 8 and 64, an odd length with
    a silent stretch (cosine > 0.9999, mean |Δ| < 0.1 dB)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    x = torch.from_numpy(_card_pcm(41, batch, 47999)).cuda()
    cfg = tfe.SpectrogramConfig(n_dft=n_dft, decibel=True)
    spec_kernel.LAUNCHES.clear()
    got = spec_kernel.spectrogram_fused(x, cfg, fast=True).cpu().numpy()
    assert spec_kernel.LAUNCHES["bf16"] == 1
    want = spec_kernel.spectrogram_fused_ref(x, cfg, fast=True).cpu().numpy()
    assert got.shape == want.shape == (batch, n_dft // 2 + 1, cfg.n_frames(47999), 1)
    assert np.isfinite(got).all()
    _gate(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("frames", [64, 128])
def test_cuda_bf16_kernels_at_either_frames_per_block(frames, monkeypatch):
    """Both block shapes the sources build (one or two consumer warpgroups),
    forced, agree with the plain versions: mel 256 and spectrogram orig,
    B = 8."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    x = torch.from_numpy(_card_pcm(42, 8, 48000)).cuda()
    _with_frames(monkeypatch, frames)
    for fn, ref, cfg in (
        (mel_kernel.melspectrogram_fused, mel_kernel.melspectrogram_fused_ref, tfe.MelConfig(n_mels=256)),
        (spec_kernel.spectrogram_fused, spec_kernel.spectrogram_fused_ref, tfe.SpectrogramConfig()),
    ):
        got = fn(x, cfg, fast=True).cpu().numpy()
        want = ref(x, cfg, fast=True).cpu().numpy()
        if not cfg.decibel:
            got, want = _db(got), _db(want)
        _gate(got, want)
    mel_kernel._launch.cache_clear()
    spec_kernel._launch.cache_clear()


def test_frames_per_block_fills_the_card_in_one_wave(monkeypatch):
    """128 frames a block, unless the 128-frame grid fills at most half of
    the SMs (132 on an H100): at 199 frames B = 8 (16 blocks) and B = 33
    (66 blocks, 132 at 64 frames) take 64, B = 34 and B = 64 take 128."""
    monkeypatch.setattr(dft_stage, "_sm_count", lambda device: 132)
    assert dft_stage.frames_per_block(8, 199, "cuda:0") == 64
    assert dft_stage.frames_per_block(33, 199, "cuda:0") == 64
    assert dft_stage.frames_per_block(34, 199, "cuda:0") == 128
    assert dft_stage.frames_per_block(64, 199, "cuda:0") == 128
    assert dft_stage.frames_per_block(1, 128, "cuda:0") == 64


@pytest.mark.cuda
def test_cuda_kernels_on_a_second_device(monkeypatch):
    """The shared-memory limit the kernels need is raised per device: after
    calls on cuda:0, each front-end kernel (bf16 at both block shapes, f32)
    launches on cuda:1 too and agrees with its plain version there."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    pcm = _card_pcm(43, 64, 48000)
    cases = (
        (mel_kernel.melspectrogram_fused, mel_kernel.melspectrogram_fused_ref, tfe.MelConfig(n_mels=256)),
        (spec_kernel.spectrogram_fused, spec_kernel.spectrogram_fused_ref, tfe.SpectrogramConfig(decibel=True)),
    )
    for device in ("cuda:0", "cuda:1"):
        for batch in (8, 64):  # 64 and 128 frames a block in bf16
            x = torch.from_numpy(pcm[:batch]).to(device)
            for fast in (True, False):
                for fn, ref, cfg in cases:
                    got = fn(x, cfg, fast=fast)
                    assert got.device == x.device
                    want = ref(x, cfg, fast=fast)
                    gates = (0.9999, 0.1) if fast else (0.999999, 0.01)
                    _gate(got.cpu().numpy(), want.cpu().numpy(), *gates)
