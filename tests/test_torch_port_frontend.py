"""The PyTorch port's mel front ends against the JAX package's.

Inputs are numpy from fixed seeds, run through both packages on the CPU.
The port's kernel wrapper takes a CPU tensor to its plain version
(``melspectrogram_fused_ref``), which is held here against the Pallas
kernel in interpret mode; the CUDA kernel itself is checked on the card
by ``chip_smoke.py`` and by the ``cuda``-marked test below.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

from l3embedding_tpu.ops import dsp_ref as jdsp
from l3embedding_tpu.ops import frontend as jfe
from l3embedding_tpu.ops.pallas_frontend import _padded_bases as jax_padded_bases
from l3embedding_tpu.ops.pallas_frontend import melspectrogram_fused as jax_fused
from l3embedding_torch.ops import dsp_ref as tdsp
from l3embedding_torch.ops import frontend as tfe
from l3embedding_torch.ops import dft_stage, fft_stage, mel_kernel

REPO = pathlib.Path(__file__).resolve().parents[1]


def _pcm(seed, batch=2, scale=0.3):
    return (np.random.RandomState(seed).randn(batch, 48000) * scale).astype(np.float32)


def _gate(ours, theirs, cos_gate, mean_db_gate):
    """Per-sample cosine and mean |Δ| (dB) between two feature batches."""
    ours, theirs = np.asarray(ours, np.float64), np.asarray(theirs, np.float64)
    assert ours.shape == theirs.shape
    for a, b in zip(ours, theirs):
        u, v = a.ravel(), b.ravel()
        cos = (u @ v) / (np.linalg.norm(u) * np.linalg.norm(v))
        assert cos > cos_gate, cos
    assert np.abs(ours - theirs).mean() < mean_db_gate


@pytest.mark.parametrize("n_mels", [128, 256])
def test_bases_equal_dsp_ref(n_mels):
    """The port's copy of dsp_ref builds bit-identical bases."""
    for n_dft, n_win in ((2048, None), (512, None), (512, 480)):
        for a, b in zip(tdsp.stft_basis(n_dft, n_win), jdsp.stft_basis(n_dft, n_win)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tdsp.periodic_hann(2048), jdsp.periodic_hann(2048))
    for htk in (True, False):
        np.testing.assert_array_equal(
            tdsp.mel_filterbank(48000, 2048, n_mels, htk=htk),
            jdsp.mel_filterbank(48000, 2048, n_mels, htk=htk),
        )
    for n in (48000, 47999, 1000):
        assert tdsp.same_pad_amounts(n, 2048, 242) == jdsp.same_pad_amounts(n, 2048, 242)
        for padding in ("same", "valid"):
            assert tdsp.num_frames(n, 512, 242, padding) == jdsp.num_frames(n, 512, 242, padding)

    # The bf16 kernel's device bases: interleaved re/im columns, unpacked,
    # are dsp_ref's bases and, in bf16, the same bits as the Pallas kernel's
    # bases, but for im_{N/2} (below 5e-13), which pair 0's packing drops;
    # the filter segments expand to the Pallas kernel's melT.
    real, imag = jdsp.stft_basis(2048)
    cols = dft_stage.interleaved(*tfe.stft_basis_f32(2048))
    assert cols.shape == (2048, 2048)
    w_re, w_im = dft_stage.unpack_pairs(cols)
    np.testing.assert_array_equal(w_re, real.astype(np.float32))
    np.testing.assert_array_equal(w_im[:, :1024], imag[:, :1024].astype(np.float32))
    assert not w_im[:, 1024].any() and np.abs(imag[:, 1024]).max() < 5e-13
    j_re, j_im, j_melt = jax_padded_bases(48000, 2048, n_mels, 0.0, None, True)
    b_re, b_im = dft_stage.unpack_pairs(
        torch.from_numpy(cols).to(torch.bfloat16).float().numpy()
    )
    np.testing.assert_array_equal(b_re, np.asarray(j_re[:, :1025], np.float32))
    np.testing.assert_array_equal(b_im[:, :1024], np.asarray(j_im[:, :1024], np.float32))
    assert np.abs(np.asarray(j_im[:, 1024], np.float32)).max() < 5e-13
    ptr, lo, w = fft_stage.mel_csr(48000, 2048, n_mels, 0.0, None, True)
    seg_ptr, segs = dft_stage.mel_segments(ptr, lo, 2048)
    melt = np.zeros((1025, n_mels), np.float32)
    for c in range(seg_ptr.size - 1):
        for head, row, length, off in segs[seg_ptr[c] : seg_ptr[c + 1]]:
            for j in range(length):
                b = 1024 if row + j == 64 else 64 * c + row + j
                melt[b, head & 0xFFFF] = w[off + j]
    np.testing.assert_array_equal(melt, j_melt[:1025] + np.float32(0.0))
    assert not j_melt[1025:].any()


def test_frame_signal_and_db_helpers_match_jax():
    x = _pcm(10, batch=2)
    for n_dft, hop, padding in ((2048, 242, "same"), (512, 242, "valid")):
        np.testing.assert_array_equal(
            tfe.frame_signal(torch.from_numpy(x), n_dft, hop, padding).numpy(),
            np.asarray(jfe.frame_signal(x, n_dft, hop, padding)),
        )
    feats = np.abs(x[:, :4000].reshape(2, 40, 100, 1)) * np.float32(3.0)
    for per_sample in (True, False):
        np.testing.assert_allclose(
            tfe.amplitude_to_db(torch.from_numpy(feats), per_sample=per_sample).numpy(),
            np.asarray(jfe.amplitude_to_db(feats, per_sample=per_sample)),
            rtol=0, atol=1e-4,
        )
    np.testing.assert_allclose(
        tfe.l3_log_norm(torch.from_numpy(feats)).numpy(),
        np.asarray(jfe.l3_log_norm(feats)), rtol=1e-6, atol=1e-6,
    )


@pytest.mark.parametrize("n_mels", [128, 256])
def test_melspectrogram_f32_matches_jax(n_mels):
    """f32 front end vs JAX's at Precision.HIGHEST: only summation order
    differs, so cosine > 0.999999 and mean |Δ| < 0.01 dB."""
    x = _pcm(0)
    theirs = np.asarray(jfe.melspectrogram(x, jfe.MelConfig(n_mels=n_mels)))
    ours = tfe.melspectrogram(torch.from_numpy(x), tfe.MelConfig(n_mels=n_mels)).numpy()
    assert ours.shape == (2, n_mels, 199, 1)
    _gate(ours, theirs, 0.999999, 0.01)


@pytest.mark.parametrize("n_mels", [128, 256])
def test_melspectrogram_bf16_matches_jax(n_mels):
    """bf16 operands with f32 accumulation in both packages: cosine >
    0.9999 and mean |Δ| < 0.1 dB (the Pallas kernel's test tolerances)."""
    x = _pcm(1)
    theirs = np.asarray(jfe.melspectrogram_bf16(x, jfe.MelConfig(n_mels=n_mels)))
    ours = tfe.melspectrogram_bf16(torch.from_numpy(x), tfe.MelConfig(n_mels=n_mels)).numpy()
    assert ours.shape == (2, n_mels, 199, 1)
    _gate(ours, theirs, 0.9999, 0.1)


@pytest.mark.parametrize("decibel", [True, False])
@pytest.mark.parametrize("n_mels", [128, 256])
def test_kernel_plain_version_matches_pallas_interpret(n_mels, decibel):
    """The kernel's plain version (bf16 operands) vs the Pallas kernel run in
    interpret mode: cosine > 0.9999 and mean |Δ| < 0.1 dB; the amplitude
    mode is compared after the same per-sample dB."""
    x = _pcm(2)
    theirs = np.asarray(
        jax_fused(x, jfe.MelConfig(n_mels=n_mels, decibel=decibel), interpret=True)
    )
    ours = mel_kernel.melspectrogram_fused(
        torch.from_numpy(x), tfe.MelConfig(n_mels=n_mels, decibel=decibel), fast=True
    ).numpy()
    assert ours.shape == theirs.shape == (2, n_mels, 199, 1)
    if not decibel:
        np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=1e-6)
        ours = jdsp.amplitude_to_db(ours, sample_axes=(1, 2))
        theirs = jdsp.amplitude_to_db(theirs, sample_axes=(1, 2))
    _gate(ours, theirs, 0.9999, 0.1)


def test_kernel_plain_version_f32_matches_jax_f32():
    """fast=False: the f32 operand mode of the kernel's plain version vs
    JAX's f32 front end, at the f32 tolerances."""
    x = _pcm(3)
    cfg = tfe.MelConfig(n_mels=256)
    ours = mel_kernel.melspectrogram_fused(torch.from_numpy(x), cfg, fast=False).numpy()
    theirs = np.asarray(jfe.melspectrogram(x, jfe.MelConfig(n_mels=256)))
    _gate(ours, theirs, 0.999999, 0.01)


@pytest.mark.parametrize("fast", [False, True])
def test_batch_global_db_with_one_loud_row(fast):
    """db_per_sample=False: one dB reference for the whole batch, so the
    row at 1/100 of the amplitude peaks near −20 dB (10·log10 of the
    amplitude); JAX's f32 front end is the reference."""
    x = _pcm(4) * np.asarray([[1.0], [0.01]], np.float32)
    cfg = tfe.MelConfig(n_mels=256, db_per_sample=False)
    ours = mel_kernel.melspectrogram_fused(torch.from_numpy(x), cfg, fast=fast).numpy()
    theirs = np.asarray(jfe.melspectrogram(x, jfe.MelConfig(n_mels=256, db_per_sample=False)))
    _gate(ours, theirs, 0.9999 if fast else 0.999999, 0.1 if fast else 0.01)
    assert abs(ours[0].max()) < 1e-5 and ours[1].max() < -15.0


def test_wrapper_checks_its_input():
    x = torch.zeros(2, 48000)
    with pytest.raises(NotImplementedError):
        mel_kernel.melspectrogram_fused(x, tfe.MelConfig(power_melgram=2.0))
    with pytest.raises(ValueError, match="unsupported device"):
        mel_kernel.melspectrogram_fused(x.to("meta"), tfe.MelConfig())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [48000, 47999])
@pytest.mark.parametrize("decibel", [True, False])
@pytest.mark.parametrize("n_mels", [256, 128])
@pytest.mark.parametrize("fast", [False, True])
def test_cuda_kernel_matches_plain_version(fast, n_mels, decibel, n, monkeypatch):
    """On the card: the CUDA kernel vs its plain version at both widths,
    dB on and off, on clips with a silent stretch, of even and odd length
    (bf16: cosine > 0.9999, mean |Δ| < 0.1 dB; f32: > 0.999999, < 0.01 dB;
    the amplitude compared after the same per-sample dB)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    pcm = _pcm(5, batch=4)[:, :n].copy()
    pcm[1, 10000:30000] = 0.0
    x = torch.from_numpy(pcm).cuda()
    cfg = tfe.MelConfig(n_mels=n_mels, decibel=decibel)
    mel_kernel.LAUNCHES.clear()
    got = mel_kernel.melspectrogram_fused(x, cfg, fast=fast).cpu().numpy()
    assert mel_kernel.LAUNCHES["bf16" if fast else "f32"] == 1
    want = mel_kernel.melspectrogram_fused_ref(x, cfg, fast=fast).cpu().numpy()
    assert got.shape == want.shape == (4, n_mels, cfg.n_frames(n), 1)
    if not decibel:
        got = jdsp.amplitude_to_db(got, sample_axes=(1, 2))
        want = jdsp.amplitude_to_db(want, sample_axes=(1, 2))
    _gate(got, want, 0.9999 if fast else 0.999999, 0.1 if fast else 0.01)


@pytest.mark.cuda
@pytest.mark.parametrize("n_dft", [64, 128, 256, 512, 1024])
def test_cuda_f32_kernel_at_every_fft_size(n_dft, monkeypatch):
    """On the card: the f32 kernel vs its plain version at the frame sizes
    its FFT is built for besides the mel types' 2048 (the test above); 64,
    256 and 1024 take the radix-2 first pass (log2 of n_dft/2 odd). 128
    mels, dB, a silent stretch (cosine > 0.999999, mean |Δ| < 0.01 dB)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    pcm = _pcm(7, batch=4)
    pcm[1, 10000:30000] = 0.0
    x = torch.from_numpy(pcm).cuda()
    cfg = tfe.MelConfig(n_dft=n_dft, n_mels=128)
    mel_kernel.LAUNCHES.clear()
    got = mel_kernel.melspectrogram_fused(x, cfg, fast=False).cpu().numpy()
    assert mel_kernel.LAUNCHES["f32"] == 1
    want = mel_kernel.melspectrogram_fused_ref(x, cfg, fast=False).cpu().numpy()
    assert got.shape == want.shape == (4, 128, cfg.n_frames(48000), 1)
    _gate(got, want, 0.999999, 0.01)


@pytest.mark.cuda
def test_cuda_f32_kernel_rejects_an_n_dft_its_fft_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    x = torch.zeros(2, 48000, device="cuda")
    mel_kernel.LAUNCHES.clear()
    with pytest.raises(ValueError, match="power of two"):
        mel_kernel.melspectrogram_fused(x, tfe.MelConfig(n_dft=1000), fast=False)
    assert not mel_kernel.LAUNCHES


@pytest.mark.parametrize("fast", [False, True])
def test_kernel_config_check_rejects_an_odd_hop(fast):
    """The check the CUDA branch runs before a launch: an odd hop raises the
    spectrogram wrapper's "even hop" ValueError (as the C entry point would
    refuse it), the registry's configurations pass, and the CPU plain version
    still takes any hop, as the Pallas kernel does."""
    odd = tfe.MelConfig(hop=241)
    with pytest.raises(ValueError, match="melspectrogram_fused: need an even hop, got hop 241"):
        mel_kernel.check_kernel_cfg(odd, fast)
    for cfg in (tfe.MelConfig(n_mels=256), tfe.MelConfig(n_mels=128)):
        mel_kernel.check_kernel_cfg(cfg, fast)
    with pytest.raises(ValueError, match="n_mels must be 128 or 256"):
        mel_kernel.check_kernel_cfg(tfe.MelConfig(n_mels=64), fast)
    out = mel_kernel.melspectrogram_fused(torch.zeros(1, 4800), odd, fast=fast)
    assert out.shape == (1, odd.n_mels, odd.n_frames(4800), 1)


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [False, True])
def test_cuda_kernel_rejects_an_odd_hop_before_a_launch(fast):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    x = torch.zeros(2, 48000, device="cuda")
    mel_kernel.LAUNCHES.clear()
    with pytest.raises(ValueError, match="even hop"):
        mel_kernel.melspectrogram_fused(x, tfe.MelConfig(hop=241), fast=fast)
    assert not mel_kernel.LAUNCHES


FORBIDDEN = ("jax", "flax", "optax", "l3embedding_tpu")


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize(
    "path",
    sorted(p.relative_to(REPO).as_posix() for p in (REPO / "l3embedding_torch").rglob("*.py"))
    + ["chip_smoke.py"],
)
def test_port_imports_nothing_of_jax(path):
    bad = [m for m in _imports(REPO / path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_ab_tool_keys_sass_by_name_without_the_namespace_hash(monkeypatch):
    """frontend_ab hashes each kernel function's SASS under its name with
    the two per-source hashes of the anonymous namespace dropped, so a
    kernel of two versions of a source is found under one name, and only a
    change of its code, not of cuobjdump's column padding, changes its
    hash."""
    from l3embedding_torch.tools import frontend_ab

    def dump(ns, body):
        head = f"\t\tFunction : _ZN48_GLOBAL__N__{ns}_15_mel_frontend_cu_{ns[::-1]}13"
        return f"{head}kernel_aEv\n{body}\n{head}kernel_bEv\n        /*0000*/ EXIT ;\n"

    def hashes(text):
        monkeypatch.setattr(frontend_ab.subprocess, "run",
                            lambda *a, **k: type("Proc", (), {"stdout": text})())
        return frontend_ab._sass_hashes("lib.so")

    a = hashes(dump("ebbc2795", "        /*0000*/ FADD R0, R1, R2 ; /* 0x0 */"))
    b = hashes(dump("058b4dd6", "        /*0000*/   FADD R0, R1, R2 ;     /* 0x0 */"))
    c = hashes(dump("058b4dd6", "        /*0000*/ FMUL R0, R1, R2 ;"))
    assert len(a) == 2 and a == b
    assert sorted(a) == sorted(c) and [a[k] == c[k] for k in sorted(a)] == [False, True]


def test_smoke_ab_tool_sums_up_a_smoke_log():
    """smoke_ab reads each run's extraction rates, AVC forward times and
    its last kernels line out of chip_smoke's output."""
    from l3embedding_torch.tools import smoke_ab

    text = "\n".join([
        "extractor cnn_L3_melspec2 fast=True short: (64, 512), launches {}, min cosine vs CPU copy 1.0",
        "extractor cnn_L3_melspec2 fast=True short: 3674.7 windows/s",
        "extractor tiny_L3 fast=False short: 12518.3 windows/s",
        "avc cnn_L3_orig fast=True: logits (8, 2), launches {'spec_frontend_bf16': 1}, cosine vs CPU "
        "copy 0.9999987 (>= 0.999), max |d|/max 2.91e-03, forward 5.094 ms at batch 8",
        '{"kernels": [{"name": "mel_frontend_bf16", "ms": 0.3131}]}',
        '{"ok": true, "device": {"platform": "gpu", "kind": "H100", "count": 1}}',
    ])
    got = smoke_ab.summary(text)
    assert got["windows_per_s"] == {"cnn_L3_melspec2 fast=True short": 3674.7,
                                    "tiny_L3 fast=False short": 12518.3}
    assert got["avc_forward_ms"] == {"cnn_L3_orig fast=True": 5.094}
    assert got["kernels"] == [{"name": "mel_frontend_bf16", "ms": 0.3131}]
    assert smoke_ab.summary("chip_smoke: no CUDA device")["kernels"] is None
