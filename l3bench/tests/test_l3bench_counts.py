"""The FLOP and byte counts match a count by hand, and the front-end bound
counts the function's work, not the running kernel's algorithm."""

import json

import pytest

from l3bench import counts, run


def config(name):
    return json.loads((run.HERE / "configs" / f"{name}.json").read_text())


def test_forward_flops_by_hand():
    # melspec2: 256 x 199 input, 3x3 SAME convs 1-64-64 | 128-128 | 256-256 |
    # 512 with VALID 2x2 pools (-> 128 x 99, 64 x 49, 32 x 24), then 512-512.
    h = [(256, 199)] * 2 + [(128, 99)] * 2 + [(64, 49)] * 2 + [(32, 24)] * 2
    chans = [(1, 64), (64, 64), (64, 128), (128, 128), (128, 256), (256, 256), (256, 512), (512, 512)]
    macs = sum(a * b * cin * cout * 9 for (a, b), (cin, cout) in zip(h, chans))
    assert 2 * macs == 20_405_256_192
    assert counts.window_flops(config("cnn_L3_melspec2")) == 20_405_256_192
    assert counts.window_flops(config("cnn_L3_orig")) == 20_325_045_888
    vision = counts.vision_macs(config("cnn_L3_melspec2"))[0]
    assert 2 * vision == 20_519_976_960


def test_train_flops_per_pair():
    cfg = config("cnn_L3_melspec2")
    fwd = 20_405_256_192 + 20_519_976_960 + 2 * (1024 * 128 + 128 * 2)
    first = 2 * (256 * 199 * 1 * 64 * 9 + 224 * 224 * 3 * 64 * 9)
    assert counts.pair_train_flops(cfg) == 3 * fwd - first == 122_544_391_680


def test_fft_frame_flops():
    # M = 256 points, log2 M = 8: a radix-4 first pass (16 a butterfly, 64
    # butterflies), three later radix-4 passes (34 each), the real post-pass.
    assert counts.fft_frame_flops(512) == 512 + 16 * 64 + 3 * 34 * 64 + 24 * 128 + 4


@pytest.mark.parametrize("fast", [True, False])
def test_ten_second_clip_bound_by_hand(fast):
    # 91 windows covering 480,000 samples; 256 mels x 199 frames a window.
    # Bytes: the PCM once and the features once, at 2 bytes a value in bf16
    # and 4 in float32, at 3.35 TB/s. Operations: the real FFT of each frame
    # and 2 a filterbank weight, at 989 (bf16) or 67 (float32) TFLOP/s.
    cfg = config("cnn_L3_melspec2")
    elem = 2 if fast else 4
    bytes_s = elem * (480_000 + 91 * 256 * 199) / 3.35e12
    nnz = counts.mel_csr(48000, 2048, 256, 0.0, True)[2].size
    ops_s = 91 * 199 * (counts.fft_frame_flops(2048) + 2 * nnz) / (989e12 if fast else 67e12)
    assert counts.frontend_bound_s(91, cfg, fast, 480_000) == pytest.approx(max(bytes_s, ops_s), rel=1e-12)
    assert (bytes_s > ops_s) == fast  # bf16 by its bytes, float32 by its operations


def test_linear_bound_by_hand():
    cfg = config("cnn_L3_orig")
    bytes_s = 4 * (480_000 + 91 * 257 * 197) / 3.35e12
    ops_s = 91 * 197 * counts.fft_frame_flops(512) / 67e12
    assert counts.frontend_bound_s(91, cfg, False, 480_000) == pytest.approx(max(bytes_s, ops_s), rel=1e-12)


def test_the_bound_does_not_count_the_kernels_dense_product():
    # The bf16 kernel runs a dense DFT product over n_dft columns; the bound
    # is the function's, many times shorter than that product alone at the
    # tensor cores' peak, so a faster algorithm reads as a higher share.
    cfg = config("cnn_L3_melspec2")
    dense = 2.0 * 91 * 199 * 2048 * 2048 / counts.PEAK_FLOPS["bf16"]
    assert counts.frontend_bound_s(91, cfg, True, 480_000) < dense / 5


def test_overlapping_windows_read_their_pcm_once():
    cfg = config("cnn_L3_orig")
    assert counts.frontend_bound_s(91, cfg, False, 480_000) < counts.frontend_bound_s(91, cfg, False)
    assert counts.frontend_bound_s(1, cfg, False, 48_000) == counts.frontend_bound_s(1, cfg, False)
