"""The PyTorch port's linear-spectrogram front end against the JAX package's.

Inputs are numpy from fixed seeds, run through both packages on the CPU.
The port's kernel wrapper (``spec_kernel.spectrogram_fused``) takes a CPU
tensor to its plain version, which is held here against the Pallas
``_spec_kernel`` in interpret mode and against JAX's XLA front ends; the
CUDA kernel itself is checked on the card by ``chip_smoke.py`` and by the
``cuda``-marked test below.
"""

import numpy as np
import pytest
import torch

from l3embedding_tpu.ops import dsp_ref as jdsp
from l3embedding_tpu.ops import frontend as jfe
from l3embedding_tpu.ops.pallas_frontend import _padded_stft_bases as jax_padded_stft_bases
from l3embedding_tpu.ops.pallas_frontend import spectrogram_fused as jax_fused
from l3embedding_torch.ops import cuda_build, dft_stage, spec_kernel
from l3embedding_torch.ops import frontend as tfe

# The three configurations the model types use, as keyword arguments of
# SpectrogramConfig in both packages, with the output shape at 48000 samples.
CONFIGS = {
    "orig": ({}, (257, 197)),
    "kapredbinputbn": ({"decibel": True}, (257, 197)),
    "tiny": ({"n_dft": 512, "hop": 240, "n_win": 480, "decibel": True}, (257, 198)),
}


def _pcm(seed, batch=2, scale=0.3):
    return (np.random.RandomState(seed).randn(batch, 48000) * scale).astype(np.float32)


def _cfgs(name, **extra):
    kw = {**CONFIGS[name][0], **extra}
    return tfe.SpectrogramConfig(**kw), jfe.SpectrogramConfig(**kw)


def _gate(ours, theirs, cos_gate, mean_gate):
    """Per-sample cosine > cos_gate and mean |Δ| < mean_gate (dB in the dB
    configurations)."""
    ours, theirs = np.asarray(ours, np.float64), np.asarray(theirs, np.float64)
    assert ours.shape == theirs.shape
    for a, b in zip(ours, theirs):
        u, v = a.ravel(), b.ravel()
        assert (u @ v) / (np.linalg.norm(u) * np.linalg.norm(v)) > cos_gate
    assert np.abs(ours - theirs).mean() < mean_gate


def _db(x):
    return jdsp.amplitude_to_db(np.asarray(x, np.float64), sample_axes=(1, 2))


@pytest.mark.parametrize("n_win", [None, 480])
def test_kernel_bases_match_pallas_bases(n_win):
    """The kernel's bases: 512 columns, re and im of each bin interleaved,
    pair 0 holding (re_0, re_256); unpacked they are dsp_ref's bases but
    for im_256 (below 2e-13), and in bf16 the Pallas kernel's bits; each
    16 KB stage holds 128 columns × 64 K values."""
    real, imag = jdsp.stft_basis(512, n_win)
    cols = dft_stage.interleaved(*tfe.stft_basis_f32(512, n_win))
    assert cols.shape == (512, 512)
    w_re, w_im = dft_stage.unpack_pairs(cols)
    np.testing.assert_array_equal(w_re, real.astype(np.float32))
    np.testing.assert_array_equal(w_im[:, :256], imag[:, :256].astype(np.float32))
    assert not w_im[:, 256].any() and np.abs(imag[:, 256]).max() < 2e-13
    j_re, j_im, n_freq = jax_padded_stft_bases(512, n_win)
    assert n_freq == 257
    b_re, b_im = dft_stage.unpack_pairs(torch.from_numpy(cols).to(torch.bfloat16).float().numpy())
    np.testing.assert_array_equal(b_re, np.asarray(j_re[:, :257], np.float32))
    np.testing.assert_array_equal(b_im[:, :256], np.asarray(j_im[:, :256], np.float32))
    tiles = dft_stage.stage_tiles(cols)
    assert tiles.shape == (4, 8, 128 * 64)
    n, k = np.meshgrid(np.arange(128), np.arange(64), indexing="ij")
    np.testing.assert_array_equal(
        tiles[1, 2][dft_stage.swizzle_index(n, k)], cols[128:256, 128:192]
    )


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_kernel_plain_version_matches_pallas_interpret(name):
    """fast=True (bf16 operands, f32 accumulation) vs the Pallas kernel in
    interpret mode, the same arithmetic summed in another order: amplitude
    within rtol 1e-4 (TestFusedLinearSpectrogram allows 2e-2 against
    float64); dB at cosine > 0.99999 and mean |Δ| < 0.01 dB (it allows
    0.9999 and 0.2 dB)."""
    x = _pcm(5)
    tcfg, jcfg = _cfgs(name)
    theirs = np.asarray(jax_fused(x, jcfg, interpret=True))
    ours = spec_kernel.spectrogram_fused(torch.from_numpy(x), tcfg, fast=True).numpy()
    assert ours.shape == theirs.shape == (2,) + CONFIGS[name][1] + (1,)
    if not tcfg.decibel:
        np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=1e-5)
        ours, theirs = _db(ours), _db(theirs)
    _gate(ours, theirs, 0.99999, 0.01)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_kernel_plain_version_f32_matches_jax_spectrogram(name):
    """fast=False vs JAX's f32 spectrogram at Precision.HIGHEST: only the
    summation order differs, so cosine > 0.999999 and mean |Δ| < 0.01 dB
    (amplitude compared after the same per-sample dB)."""
    x = _pcm(6)
    tcfg, jcfg = _cfgs(name)
    theirs = np.asarray(jfe.spectrogram(x, jcfg))
    ours = spec_kernel.spectrogram_fused(torch.from_numpy(x), tcfg, fast=False).numpy()
    assert ours.shape == theirs.shape
    if not tcfg.decibel:
        _gate(ours, theirs, 0.999999, 1e-4)
        ours, theirs = _db(ours), _db(theirs)
    _gate(ours, theirs, 0.999999, 0.01)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_spectrogram_matches_jax(name, bf16):
    """frontend.spectrogram (f32: cosine > 0.999999, mean |Δ| < 0.01 dB)
    and spectrogram_bf16 (bf16 operands in both: > 0.9999, < 0.1 dB)
    against their JAX counterparts."""
    x = _pcm(7)
    tcfg, jcfg = _cfgs(name)
    if bf16:
        theirs = np.asarray(jfe.spectrogram_bf16(x, jcfg))
        ours = tfe.spectrogram_bf16(torch.from_numpy(x), tcfg).numpy()
        gates = (0.9999, 0.1)
    else:
        theirs = np.asarray(jfe.spectrogram(x, jcfg))
        ours = tfe.spectrogram(torch.from_numpy(x), tcfg).numpy()
        gates = (0.999999, 0.01)
    if not tcfg.decibel:
        ours, theirs = _db(ours), _db(theirs)
    _gate(ours, theirs, *gates)


def test_power_two_and_other_powers_match_jax():
    """power 2 (no root) and power 1.5 (^(power/2)) in the plain version,
    against JAX's f32 spectrogram, dB of that |STFT|^power."""
    x = _pcm(8)
    for power in (2.0, 1.5):
        tcfg, jcfg = _cfgs("kapredbinputbn", power=power)
        theirs = np.asarray(jfe.spectrogram(x, jcfg))
        ours = spec_kernel.spectrogram_fused(torch.from_numpy(x), tcfg).numpy()
        _gate(ours, theirs, 0.999999, 0.01)


def test_log_norm_with_a_silent_stretch():
    """cnn_L3_orig's front end (amplitude, then log(max(x, 1e-12))/5) on a
    clip with 0.4 s of digital silence: the silent frames sit at
    log(1e-12)/5 in both packages, and rounding on the near-zero bins at
    its edges is bounded by a mean |Δ| < 1e-3 in the log-norm domain."""
    x = _pcm(9)
    x[:, 10000:30000] = 0.0
    tcfg, jcfg = _cfgs("orig")
    theirs = np.asarray(jfe.l3_log_norm(jfe.spectrogram(x, jcfg)))
    ours = tfe.l3_log_norm(
        spec_kernel.spectrogram_fused(torch.from_numpy(x), tcfg, fast=False)
    ).numpy()
    assert np.isfinite(ours).all()
    silent = ours[:, :, 45:120]  # frames wholly inside the zeroed span
    np.testing.assert_allclose(silent, np.log(1e-12) / 5.0, rtol=1e-6)
    assert np.abs(ours - theirs).mean() < 1e-3


@pytest.mark.parametrize("fast", [False, True])
def test_batch_global_db_with_one_loud_row(fast):
    """db_per_sample=False: one dB reference for the whole batch, so the
    row at 1/100 of the amplitude peaks near −20 dB (10·log10 of the
    amplitude); JAX's f32 front end is the reference."""
    x = _pcm(10) * np.asarray([[1.0], [0.01]], np.float32)
    tcfg, jcfg = _cfgs("kapredbinputbn", db_per_sample=False)
    ours = spec_kernel.spectrogram_fused(torch.from_numpy(x), tcfg, fast=fast).numpy()
    theirs = np.asarray(jfe.spectrogram(x, jcfg))
    _gate(ours, theirs, 0.9999 if fast else 0.999999, 0.1 if fast else 0.01)
    assert abs(ours[0].max()) < 1e-5 and ours[1].max() < -15.0


def test_wrapper_checks_its_input():
    x = torch.zeros(2, 48000)
    with pytest.raises(ValueError, match="unsupported device"):
        spec_kernel.spectrogram_fused(x.to("meta"), tfe.SpectrogramConfig())
    with pytest.raises(ValueError, match="even hop"):
        spec_kernel.spectrogram_fused(x, tfe.SpectrogramConfig(hop=241))
    with pytest.raises(ValueError, match="even hop"):
        spec_kernel.spectrogram_fused_ref(x, tfe.SpectrogramConfig(n_dft=500))


def test_build_name_hashes_source_and_headers(tmp_path, monkeypatch):
    """Both kernel sources include the two stages (the bf16 DFT product and
    the f32 FFT) and the header those share, and the built library's name
    changes when any of the headers does, so an edited header never loads
    a stale library."""
    headers = ["fft_stage.cuh", "frontend_common.cuh", "dft_stage.cuh"]
    for name in ("mel_frontend", "spec_frontend"):
        files = [p.name for p in cuda_build.source_files(cuda_build.CSRC / f"{name}.cu")]
        assert files == [f"{name}.cu"] + headers
    for path in cuda_build.source_files(cuda_build.CSRC / "spec_frontend.cu"):
        (tmp_path / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    names = {cuda_build.library_path("spec_frontend")}
    assert all(n.name.startswith("libspec_frontend_") and n.suffix == ".so" for n in names)
    for header in headers:
        path = tmp_path / header
        path.write_text(path.read_text() + "\n// edited\n")
        names.add(cuda_build.library_path("spec_frontend"))
    assert len(names) == 1 + len(headers)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [48000, 47999])
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize(
    "name,per_sample",
    [("orig", True), ("kapredbinputbn", True), ("kapredbinputbn", False), ("tiny", True), ("tiny", False)],
)
def test_cuda_kernel_matches_plain_version(name, per_sample, fast, n, monkeypatch):
    """On the card: the CUDA kernel vs its plain version in every
    configuration chip_smoke.py checks (per-sample and batch-global dB), on
    clips with a silent stretch, of even and odd length (bf16: cosine >
    0.9999, mean |Δ| < 0.1 dB; f32: > 0.999999, < 0.01 dB)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    pcm = _pcm(11, batch=4)[:, :n].copy()
    pcm[1, 10000:30000] = 0.0
    x = torch.from_numpy(pcm).cuda()
    tcfg, _ = _cfgs(name, **({} if per_sample else {"db_per_sample": False}))
    spec_kernel.LAUNCHES.clear()
    got = spec_kernel.spectrogram_fused(x, tcfg, fast=fast).cpu().numpy()
    assert spec_kernel.LAUNCHES["bf16" if fast else "f32"] == 1
    want = spec_kernel.spectrogram_fused_ref(x, tcfg, fast=fast).cpu().numpy()
    assert got.shape == want.shape == (4, 257, tcfg.n_frames(n), 1)
    if not tcfg.decibel:
        got, want = _db(got), _db(want)
    _gate(got, want, 0.9999 if fast else 0.999999, 0.1 if fast else 0.01)


@pytest.mark.cuda
@pytest.mark.parametrize("n_dft", [64, 128, 256, 1024, 2048])
def test_cuda_f32_kernel_at_every_fft_size(n_dft, monkeypatch):
    """On the card: the f32 kernel vs its plain version at the frame sizes
    its FFT is built for besides the model types' 512 (the test above); 64,
    256 and 1024 take the radix-2 first pass (log2 of n_dft/2 odd). dB, a
    silent stretch (cosine > 0.999999, mean |Δ| < 0.01 dB)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    pcm = _pcm(13, batch=4)
    pcm[1, 10000:30000] = 0.0
    x = torch.from_numpy(pcm).cuda()
    tcfg = tfe.SpectrogramConfig(n_dft=n_dft, decibel=True)
    spec_kernel.LAUNCHES.clear()
    got = spec_kernel.spectrogram_fused(x, tcfg, fast=False).cpu().numpy()
    assert spec_kernel.LAUNCHES["f32"] == 1
    want = spec_kernel.spectrogram_fused_ref(x, tcfg, fast=False).cpu().numpy()
    assert got.shape == want.shape == (4, n_dft // 2 + 1, tcfg.n_frames(48000), 1)
    _gate(got, want, 0.999999, 0.01)


@pytest.mark.cuda
def test_cuda_f32_kernel_rejects_an_n_dft_its_fft_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    x = torch.zeros(2, 48000, device="cuda")
    spec_kernel.LAUNCHES.clear()
    with pytest.raises(ValueError, match="power of two"):
        spec_kernel.spectrogram_fused(x, tfe.SpectrogramConfig(n_dft=576), fast=False)
    assert not spec_kernel.LAUNCHES
