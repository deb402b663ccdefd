"""The host side of the f32 front-end kernels' real FFT (``csrc/fft_stage.cuh``,
``l3embedding_torch/ops/fft_stage.py``), checked on the CPU.

The tables the kernels read are held against their float64 definitions,
and a float32 numpy model of the kernels' schedule (the same tables, the
same Stockham pass order, the real post-pass, the window applied on load,
the CSR mel sum) is held against the plain versions and against the JAX
package's f32 front ends. An index error in the FFT shows here, before
the kernel runs on a card.
"""

import numpy as np
import pytest
import torch

from l3embedding_tpu.ops import dsp_ref as jdsp
from l3embedding_tpu.ops import frontend as jfe
from l3embedding_torch.ops import fft_stage, mel_kernel
from l3embedding_torch.ops import frontend as tfe

# The linear front end's three configurations, with a silent stretch.
SPEC_CONFIGS = {
    "orig": {},
    "kapredbinputbn": {"decibel": True},
    "tiny": {"n_dft": 512, "hop": 240, "n_win": 480, "decibel": True},
}


def _pcm(seed, batch=2, scale=0.3, silent=False):
    x = (np.random.RandomState(seed).randn(batch, 48000) * scale).astype(np.float32)
    x *= np.float32(10.0) ** np.linspace(0, -1, batch, dtype=np.float32)[:, None]
    if silent:
        x[:, 10000:30000] = 0.0
    return x


def _gate(ours, theirs, cos_gate=0.999999, mean_gate=0.01):
    """Per-sample cosine > cos_gate and mean |Δ| < mean_gate (dB)."""
    ours, theirs = np.asarray(ours, np.float64), np.asarray(theirs, np.float64)
    assert ours.shape == theirs.shape
    for a, b in zip(ours, theirs):
        u, v = a.ravel(), b.ravel()
        assert (u @ v) / (np.linalg.norm(u) * np.linalg.norm(v)) > cos_gate
    assert np.abs(ours - theirs).mean() < mean_gate


def _db(x):
    return jdsp.amplitude_to_db(np.asarray(x, np.float64), sample_axes=(1, 2))


# --- the model of the kernels' schedule, in float32 -------------------------


def _cplx(table):
    return (table[..., 0] + 1j * table[..., 1]).astype(np.complex64)


def _fft_model(z, tw):
    """Stockham FFT of z (..., M) in place order: a radix-2 pass first when
    log2 M is odd, then radix-4 passes. Pass with product P and radix R:
    butterfly i takes z[i + r·M/R], twiddles input r by tw[r·k·M/(P·R)]
    (k = i mod P), and writes output r to (i − k)·R + k + r·P."""
    m = z.shape[-1]
    log2m = m.bit_length() - 1
    p = 1
    for radix in [2] * (log2m % 2) + [4] * (log2m // 2):
        nb = m // radix
        i = np.arange(nb)
        k = i & (p - 1)
        v = [z[..., i + r * nb] for r in range(radix)]
        if p > 1:
            v = [v[0]] + [v[r] * tw[r * k * (m // (p * radix))] for r in range(1, radix)]
        if radix == 2:
            v = [v[0] + v[1], v[0] - v[1]]
        else:
            s02, d02, s13, d13 = v[0] + v[2], v[0] - v[2], v[1] + v[3], v[1] - v[3]
            mi_d13 = (d13.imag - 1j * d13.real).astype(np.complex64)  # −i·d13
            v = [s02 + s13, d02 + mi_d13, s02 - s13, d02 - mi_d13]
        out = np.empty_like(z)
        for r in range(radix):
            out[..., (i - k) * radix + k + r * p] = v[r]
        z, p = out, p * radix
    return z


def _real_power_model(zf, twp):
    """|X[k]|², k = 0…M, from Z = FFT_M(z) by the kernel's post-pass."""
    m = zf.shape[-1]
    k = np.arange(1, m // 2 + 1)
    a, b = zf[..., k], zf[..., m - k]
    half = np.float32(0.5)
    er, ei = half * (a.real + b.real), half * (a.imag - b.imag)
    dr, di = half * (a.real - b.real), half * (a.imag + b.imag)
    w = twp[k]
    wr, wi = w.real * dr - w.imag * di, w.real * di + w.imag * dr
    p = np.empty(zf.shape[:-1] + (m + 1,), np.float32)
    z0 = zf[..., 0]
    p[..., 0] = (z0.real + z0.imag) ** 2
    p[..., m] = (z0.real - z0.imag) ** 2
    p[..., k] = (er + wi) ** 2 + (ei - wr) ** 2
    p[..., m - k] = (er - wi) ** 2 + (-ei - wr) ** 2
    return p


def _power_model(x, n_dft, hop, padding, n_win=None):
    """(B, n) → (B, T, n_dft/2 + 1) power, as the f32 kernels compute it."""
    frames = tfe.frame_signal(torch.from_numpy(x), n_dft, hop, padding).numpy()
    xw = frames * fft_stage.window(n_dft, n_win)  # the window, on load
    z = (xw[..., 0::2] + 1j * xw[..., 1::2]).astype(np.complex64)
    tw, twp = _cplx(fft_stage.twiddles(n_dft))
    return _real_power_model(_fft_model(z, tw), twp)


def _mel_model(x, cfg):
    p = _power_model(x, cfg.n_dft, cfg.hop, cfg.padding)
    ptr, lo, w = fft_stage.mel_csr(cfg.sr, cfg.n_dft, cfg.n_mels, cfg.fmin, cfg.fmax, cfg.htk)
    mel = np.zeros(p.shape[:-1] + (cfg.n_mels,), np.float32)
    for m in range(cfg.n_mels):
        for j, o in enumerate(range(ptr[m], ptr[m + 1])):
            mel[..., m] = mel[..., m] + w[o] * p[..., lo[m] + j]
    return tfe.to_nhwc_db(torch.sqrt(torch.from_numpy(mel).clamp(min=0.0)), cfg).numpy()


def _spec_model(x, cfg):
    p = _power_model(x, cfg.n_dft, cfg.hop, cfg.padding, cfg.n_win)
    return tfe.to_nhwc_db(torch.from_numpy(np.sqrt(p)), cfg).numpy()


# --- tests -------------------------------------------------------------------


def _pad(n):
    return n + (n >> 4)  # fft_pad: one spare slot after every 16 points


def _passes(m):
    """(radix, P) of each Stockham pass, in order."""
    log2m, p, out = m.bit_length() - 1, 1, []
    for radix in [2] * (log2m % 2) + [4] * (log2m // 2):
        out.append((radix, p))
        p *= radix
    return out


@pytest.mark.parametrize("m", [32, 64, 128, 256, 512, 1024])
def test_padded_addresses_split_into_lane_and_constant_parts(m):
    """fft_stage.cuh addresses point n at fft_pad(lane part) +
    fft_pad(constant part): the split must give n, and the two parts' low
    four bits must never carry, for every pass, lane, butterfly and output
    at every size; the padded stores of a pass fill distinct slots."""
    for radix, p in _passes(m):
        nb, pj = m // radix, max(p // 32, 1)
        stores = set()
        for lane in range(32):
            k_lane = lane & (p - 1)
            w_lane = radix * (lane - k_lane) + k_lane
            for j in range(-(-nb // 32)):
                i = lane + 32 * j
                if i >= nb:
                    continue
                k = i % p
                assert k == k_lane + 32 * (j % pj)
                for r in range(radix):
                    c_in = 32 * j + r * nb
                    assert _pad(lane + c_in) == _pad(lane) + _pad(c_in)
                    c_out = 32 * radix * (j - j % pj) + 32 * (j % pj) + r * p
                    assert w_lane + c_out == (i - k) * radix + k + r * p
                    assert _pad(w_lane + c_out) == _pad(w_lane) + _pad(c_out)
                    stores.add(_pad(w_lane + c_out))
        assert len(stores) == m and max(stores) < _pad(m - 1) + 1
    for lane in range(32):  # the real post-pass reads Z[k] and Z[M − k]
        for j in range(-(-(m // 2 + 1) // 32)):
            k = lane + 32 * j
            if 0 < k <= m // 2:
                assert _pad(k) == _pad(lane) + _pad(32 * j)
                assert _pad(m - k) == _pad(32 - lane) + _pad(m - 32 - 32 * j)


@pytest.mark.parametrize("n_mels,nnz,empty", [(256, 2032, 2), (128, 2018, 0)])
def test_mel_csr_expands_to_mel_matrix(n_mels, nnz, empty):
    """The CSR rows give back mel_matrix_f32 bit for bit (its −0.0 weights,
    which add nothing, as 0.0); each bin feeds at most 2 filters; the
    counts of nonzeros and empty filters at sr 48000, n_dft 2048."""
    key = (48000, 2048, n_mels, 0.0, None, True)
    ptr, lo, w = fft_stage.mel_csr(*key)
    dense = tfe.mel_matrix_f32(*key) + np.float32(0.0)
    expanded = np.zeros_like(dense)
    for m in range(n_mels):
        run = w[ptr[m] : ptr[m + 1]]
        expanded[lo[m] : lo[m] + run.size, m] = run
    np.testing.assert_array_equal(expanded.view(np.uint32), dense.view(np.uint32))
    assert ptr[0] == 0 and ptr[-1] == w.size == nnz == np.count_nonzero(dense)
    assert (np.count_nonzero(dense, axis=1) <= 2).all()
    assert int((np.diff(ptr) == 0).sum()) == empty
    assert ptr.dtype == lo.dtype == np.int32 and w.dtype == np.float32


@pytest.mark.parametrize("n_dft,n_win", [(2048, None), (512, None), (512, 480), (64, None)])
def test_tables_are_float64_rounded_once(n_dft, n_win):
    """Twiddles are float64 cos/sin and the window is periodic_hann centred
    in the frame, each rounded once to f32."""
    m = n_dft // 2
    tw = fft_stage.twiddles(n_dft)
    assert tw.shape == (2, m, 2) and tw.dtype == np.float32
    for table, period in ((tw[0], m), (tw[1], n_dft)):
        angle = -2.0 * np.pi * np.arange(m) / period
        np.testing.assert_array_equal(table[:, 0], np.cos(angle).astype(np.float32))
        np.testing.assert_array_equal(table[:, 1], np.sin(angle).astype(np.float32))
    win = np.zeros(n_dft)
    lpad = (n_dft - (n_win or n_dft)) // 2
    win[lpad : lpad + (n_win or n_dft)] = jdsp.periodic_hann(n_win or n_dft)
    np.testing.assert_array_equal(fft_stage.window(n_dft, n_win), win.astype(np.float32))


@pytest.mark.parametrize("m", [32, 64, 128, 256, 512, 1024])
def test_fft_model_is_the_dft(m):
    """The pass order and index maps give the DFT at every size the
    kernels take, odd log2 M (a radix-2 pass) included."""
    rng = np.random.RandomState(m)
    z = (rng.randn(2, m) + 1j * rng.randn(2, m)).astype(np.complex64)
    got = _fft_model(z, _cplx(fft_stage.twiddles(2 * m))[0])
    want = np.fft.fft(z.astype(np.complex128))
    assert np.abs(got - want).max() < 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("m", [32, 1024])
def test_real_post_pass_is_the_real_dft(m):
    rng = np.random.RandomState(m)
    x = rng.randn(2, 2 * m).astype(np.float32)
    z = (x[:, 0::2] + 1j * x[:, 1::2]).astype(np.complex64)
    tw, twp = _cplx(fft_stage.twiddles(2 * m))
    got = _real_power_model(_fft_model(z, tw), twp)
    want = np.abs(np.fft.rfft(x.astype(np.float64))) ** 2
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * want.max())


@pytest.mark.parametrize("n_mels", [256, 128])
def test_mel_model_matches_plain_version_and_jax(n_mels):
    """The model of the f32 mel kernel vs melspectrogram_fused_ref(fast=False)
    and JAX's f32 melspectrogram: cosine > 0.999999, mean |Δ| < 0.01 dB."""
    x = _pcm(20, silent=True)
    cfg = tfe.MelConfig(n_mels=n_mels)
    ours = _mel_model(x, cfg)
    assert ours.shape == (2, n_mels, 199, 1) and np.isfinite(ours).all()
    _gate(ours, mel_kernel.melspectrogram_fused_ref(torch.from_numpy(x), cfg, fast=False).numpy())
    _gate(ours, np.asarray(jfe.melspectrogram(x, jfe.MelConfig(n_mels=n_mels))))


@pytest.mark.parametrize("name", sorted(SPEC_CONFIGS))
def test_spec_model_matches_jax(name):
    """The model of the f32 spectrogram kernel vs JAX's f32 spectrogram on
    clips with a silent stretch: cosine > 0.999999, mean |Δ| < 0.01 dB
    (amplitude compared after the same per-sample dB)."""
    x = _pcm(21, silent=True)
    kw = SPEC_CONFIGS[name]
    tcfg, jcfg = tfe.SpectrogramConfig(**kw), jfe.SpectrogramConfig(**kw)
    ours, theirs = _spec_model(x, tcfg), np.asarray(jfe.spectrogram(x, jcfg))
    assert ours.shape == theirs.shape and np.isfinite(ours).all()
    if not tcfg.decibel:
        ours, theirs = _db(ours), _db(theirs)
    _gate(ours, theirs)


@pytest.mark.parametrize("n_dft", [48, 96, 500, 576, 1000, 4096, 32])
def test_n_dft_check_rejects(n_dft):
    with pytest.raises(ValueError, match="power of two"):
        fft_stage.check_n_dft(n_dft, "test")


def test_n_dft_check_takes_powers_of_two():
    for log2 in range(6, 12):
        fft_stage.check_n_dft(2**log2, "test")
