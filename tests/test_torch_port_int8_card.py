"""The int8 conv kernel and the int8 tower on the card (``-m cuda``; they skip
without a CUDA device). This file imports nothing of JAX or flax, so it
collects on the card's machine."""

import numpy as np
import pytest
import torch

from l3embedding_torch.ops import int8_conv_kernel as ick


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("cin, cout, h, w", [(1, 64, 9, 7), (64, 64, 5, 13), (128, 192, 3, 4), (96, 64, 6, 6)])
@pytest.mark.parametrize("requant", [True, False])
def test_cuda_int8_conv_matches_plain(cin, cout, h, w, requant):
    """The kernel against its plain version at ragged shapes (a pixel count
    that is not a multiple of the block's 128, Cin 1, 96 and 128, Cout 192):
    int8 outputs and the f32 epilogue equal."""
    _need_cuda()
    rng = np.random.RandomState(cin + cout)
    x = torch.from_numpy(rng.randint(-127, 128, (3, h, w, cin)).astype(np.int8)).cuda()
    wp = ick.pack_weights(rng.randint(-127, 128, (3, 3, cin, cout)).astype(np.int8)).cuda()
    deq = torch.from_numpy((rng.uniform(0.5, 1.5, cout) / (np.sqrt(9 * cin) * 127 * 73)).astype(np.float32)).cuda()
    bias = torch.from_numpy((rng.randn(cout) * 0.1).astype(np.float32)).cuda()
    s_next = torch.tensor([2.5 / 127], device="cuda") if requant else None
    ick.LAUNCHES.clear()
    got = ick.conv3x3_s8(x, wp, deq, bias, s_next)
    assert ick.LAUNCHES["s8"] == 1
    want = ick.conv3x3_s8_ref(x, wp, deq, bias, s_next)
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_int8_tower_matches_cpu(tmp_path):
    """One artifact, the tower on the card and on the CPU: rows at cosine
    >= 0.9999 (the int32 products are exact on both; the f32 front end and
    epilogues may move a rounding)."""
    _need_cuda()
    from l3embedding_torch.embed.quantized import QuantizedEmbeddingExtractor

    rng = np.random.RandomState(0)
    windows = (rng.randn(4, 48000) * 0.2).astype(np.float32)
    ex = QuantizedEmbeddingExtractor(None, "cnn_L3_melspec1", "short", device="cuda")
    ex.q.calibrate(windows)
    art = str(tmp_path / "t.npz")
    ex.save_artifact(art)
    got = ex.embed_windows(windows)
    want = QuantizedEmbeddingExtractor.load_artifact(art, min_cosine=None, device="cpu").embed_windows(windows)
    cos = (got * want).sum(1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(want, axis=1))
    assert cos.min() >= 0.9999
