"""The int8 conv kernel and the int8 tower on the card (``-m cuda``; they skip
without a CUDA device), and on the CPU a numpy model of the wgmma kernel's
schedule (tile plan, wide pixels, slab reads, epilogue placement, pooling)
and of its requantize shortcut, against the plain version. This file
imports nothing of JAX or flax, so it collects on the card's machine."""

import numpy as np
import pytest
import torch
from torch_port_threads import one_torch_thread  # noqa: F401

from l3embedding_torch.ops import int8_conv_kernel as ick
from l3embedding_torch.tools import int8_ab


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("cin, cout, h, w", [(1, 64, 9, 7), (64, 64, 5, 13), (128, 192, 3, 4), (96, 64, 6, 6)])
@pytest.mark.parametrize("requant", [True, False])
def test_cuda_int8_conv_matches_plain(cin, cout, h, w, requant):
    """The kernel against its plain version at ragged shapes (a pixel count
    that is not a multiple of a tile, Cin 1 (__dp4a), 96 (the general
    mma.sync kernel), 64 and 128 (wgmma), Cout 192): int8 outputs and the
    f32 epilogue equal."""
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


def _operands(cin, cout, h, w, requant, batch=3, relu_input=False):
    rng = np.random.RandomState(cin + cout + h + w)
    x = rng.randint(-127, 128, (batch, h, w, cin)).astype(np.int8)
    if relu_input:
        x = np.maximum(x, 0)
    wp = ick.pack_weights(rng.randint(-127, 128, (3, 3, cin, cout)).astype(np.int8))
    deq = torch.from_numpy((rng.uniform(0.5, 1.5, cout) / (np.sqrt(9 * cin) * 127 * 73)).astype(np.float32))
    bias = torch.from_numpy((rng.randn(cout) * 0.1).astype(np.float32))
    s_next = torch.tensor([2.5 / 127]) if requant else None
    return torch.from_numpy(x), wp, deq, bias, s_next


# Pooled shapes: odd and even H and W, a pixel count that is no multiple of a
# tile, Cout 64, 192 and 512, W past one tile (> 206) and the tower's widths.
POOLED = [(64, 64, 7, 13), (64, 192, 6, 10), (128, 512, 5, 9), (64, 64, 4, 199), (64, 128, 3, 211),
          (128, 64, 9, 99), (256, 64, 5, 49)]


@pytest.mark.cuda
@pytest.mark.parametrize("cin, cout, h, w", POOLED)
def test_cuda_int8_conv_pooled_matches_plain(cin, cout, h, w):
    """The pooled kernel (requant, then the 2×2 VALID max-pool in its
    epilogue) equals the plain conv followed by pool2_int8, at ragged
    shapes; one launch a call."""
    _need_cuda()
    x, wp, deq, bias, s_next = (t.cuda() for t in _operands(cin, cout, h, w, True, relu_input=True))
    ick.LAUNCHES.clear()
    got = ick.conv3x3_s8(x, wp, deq, bias, s_next, pool=True)
    assert ick.LAUNCHES["s8"] == 1
    want = ick.conv3x3_s8_ref(x, wp, deq, bias, s_next, pool=True)
    assert got.shape == (3, h // 2, w // 2, cout) and got.dtype == torch.int8 and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("cin, cout, h, w", [(64, 64, 9, 207), (512, 192, 4, 24), (128, 64, 1, 1)])
@pytest.mark.parametrize("requant", [True, False])
def test_cuda_int8_conv_wgmma_tiles_match_plain(cin, cout, h, w, requant):
    """The wgmma kernel at widths past one tile (207: tiles of 206 and 1),
    the tower's narrowest tile (8 rows of 24) and a 1 × 1 image: int8 and
    f32 outputs equal the plain version."""
    _need_cuda()
    x, wp, deq, bias, s_next = (None if t is None else t.cuda() for t in _operands(cin, cout, h, w, requant))
    got = ick.conv3x3_s8(x, wp, deq, bias, s_next)
    want = ick.conv3x3_s8_ref(x, wp, deq, bias, s_next)
    assert got.dtype == want.dtype and torch.equal(got, want)


def _schedule_model(x, wp, deq, bias, s_next, pool, seed=0):
    """The wgmma kernel's schedule in numpy: per tile of tile_plan, the slab
    of (TH + 2) × (TW + 2) pixels (zeros outside the image) followed by
    garbage up to the shared memory the kernel reserves, each tap's product
    over WIDE wide pixels started dy·SW + dx into the slab, the wide pixels
    kept (row i // SW < TH, column i % SW < TW) and clipped to the image,
    and pooled quads taken inside the tile."""
    rng = np.random.RandomState(seed)
    b_, h, w, cin = x.shape
    cout = wp.shape[0]
    th, tw = ick.tile_plan(h, w, pool)
    sw, sh = tw + 2, th + 2
    assert (th - 1) * sw + tw <= ick.WIDE and (not pool or (th % 2 == 0 and (tw % 2 == 0 or tw >= w)))
    slab_pix = max(sh * sw, ick.WIDE + 2 * sw + 2)
    wt = wp[:, : 9 * cin].numpy().astype(np.int64).reshape(cout, 9, cin)
    xn = x.numpy().astype(np.int64)
    out = np.zeros((b_, h // 2, w // 2, cout) if pool else (b_, h, w, cout), np.float32 if s_next is None else np.int8)
    for b in range(b_):
        for h0 in range(0, h, th):
            for w0 in range(0, w, tw):
                slab = np.zeros((sh, sw, cin), np.int64)
                for r in range(sh):
                    for c in range(sw):
                        hh, ww = h0 - 1 + r, w0 - 1 + c
                        if 0 <= hh < h and 0 <= ww < w:
                            slab[r, c] = xn[b, hh, ww]
                flat = np.concatenate([slab.reshape(-1, cin),
                                       rng.randint(-127, 128, (slab_pix - sh * sw, cin))])
                acc = np.zeros((ick.WIDE, cout), np.int64)
                for tap in range(9):
                    s0 = (tap // 3) * sw + tap % 3
                    acc += flat[s0 : s0 + ick.WIDE] @ wt[:, tap].T
                acc_t = torch.from_numpy(acc.astype(np.int32))
                y = (ick.dequant_epilogue(acc_t, deq, bias) if s_next is None
                     else ick.requant_epilogue(acc_t, deq, bias, s_next)).numpy()
                tile = np.zeros((th, tw, cout), y.dtype)
                for i in range(ick.WIDE):
                    r, c = divmod(i, sw)
                    if r < th and c < tw:
                        tile[r, c] = y[i]
                if pool:
                    q = tile[: th // 2 * 2, : tw // 2 * 2].reshape(th // 2, 2, tw // 2, 2, cout).max(axis=(1, 3))
                    oh, ow = min(th // 2, h // 2 - h0 // 2), min(tw // 2, w // 2 - w0 // 2)
                    if oh > 0 and ow > 0:
                        out[b, h0 // 2 : h0 // 2 + oh, w0 // 2 : w0 // 2 + ow] = q[:oh, :ow]
                else:
                    oh, ow = min(th, h - h0), min(tw, w - w0)
                    out[b, h0 : h0 + oh, w0 : w0 + ow] = tile[:oh, :ow]
    return torch.from_numpy(out)


@pytest.mark.parametrize("cin, cout, h, w, requant, pool", [
    (64, 64, 5, 199, True, True), (64, 128, 4, 99, True, False), (64, 64, 6, 99, True, True),
    (64, 64, 9, 49, True, True), (64, 128, 17, 24, False, False), (64, 64, 3, 211, True, True),
    (64, 64, 2, 207, True, False), (64, 64, 7, 5, True, True), (64, 64, 1, 1, False, False)])
def test_wgmma_schedule_model_matches_plain(cin, cout, h, w, requant, pool):
    """The wgmma kernel's tile walk, modelled in numpy, equals the plain
    version bit for bit: the plan's tiles cover the image, every kept wide
    pixel reads only its own slab pixels (the garbage past the slab reaches
    only dropped ones), and pooled quads never straddle tiles."""
    x, wp, deq, bias, s_next = _operands(cin, cout, h, w, requant, batch=1, relu_input=pool)
    got = _schedule_model(x, wp, deq, bias, s_next, pool)
    want = ick.conv3x3_s8_ref(x, wp, deq, bias, s_next, pool=pool)
    assert got.dtype == want.dtype and torch.equal(got, want)


def _requant_shortcut(y, s):
    """csrc/int8_conv.cu::requant in numpy float32: t = min(y·(1/s), 127)
    rounded half to even by adding 1.5·2^23 (the integer read from the
    sum's bits), unless t is within 2.5e-7·t of a half-integer: then
    requant_exact's y / s."""
    y, s = np.float32(y), np.float32(s)
    magic = np.float32(12582912.0)
    t = np.minimum(np.float32(y * (np.float32(1) / s)), np.float32(127))
    m = np.float32(t + magic)
    r = np.float32(m - magic)
    if abs(abs(np.float32(t - r)) - np.float32(0.5)) > t * np.float32(2.5e-7):
        return int(np.array(m, np.float32).view(np.int32)) - 0x4B400000
    return int(np.clip(np.rint(np.float32(y / s)), -127, 127))


def test_requant_shortcut_equals_division():
    """The kernel's requantize shortcut gives the integer of the f32
    division on random quotients (past the 127 clip too) and on quotients
    at, and one ulp either side of, every half-integer up to 127.5."""
    rng = np.random.RandomState(3)
    ss = np.float32(rng.uniform(1e-3, 1.0, 40))
    for s in ss:
        ys = [np.float32(v) for v in rng.uniform(0, 140 * s, 200)]
        for k in range(128):
            y = np.float32((k + 0.5) * s)
            ys += [y, np.nextafter(y, np.float32(0)), np.nextafter(y, np.float32(1e9))]
        for y in ys:
            assert _requant_shortcut(y, s) == np.clip(np.rint(np.float32(y / s)), -127, 127), (y, s)


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


def test_int8_ab_library_call_and_bound():
    """tools/int8_ab.py: the library yardstick (im2col + torch._int_mm +
    the epilogue, + the pool) computes the plain version's function, and a
    pooled call's bound writes a quarter (floor) of the output bytes."""
    for cin, pool in ((64, True), (64, False), (1, False)):
        x, wp, deq, bias, s_next = _operands(cin, 64, 5, 7, True, batch=2, relu_input=cin > 1)
        want = ick.conv3x3_s8_ref(x, wp, deq, bias, s_next, pool=pool)
        assert torch.equal(int8_ab.library_int8_conv(x, wp, deq, bias, s_next, pool=pool), want)
    ops, plain = int8_ab.int8_conv_bound(64, 256, 199, 64, 64, True)
    ops_p, pooled = int8_ab.int8_conv_bound(64, 256, 199, 64, 64, True, pool=True)
    out_bytes = 64 * 256 * 199 * 64
    assert ops_p == ops and (plain - pooled) * int8_ab.PEAK_HBM == pytest.approx(out_bytes - 64 * 128 * 99 * 64)


def test_int8_ab_sass_counts_by_kernel(monkeypatch):
    """int8_ab --sass: each kernel function of cuobjdump's text under its
    name with the template argument (int8_conv3x3_wgmma_kernel<1>), and its
    IGMMA / IMMA / UTMALDG / IDP counts."""
    head = "\t\tFunction : _ZN45_GLOBAL__N__8ee23745_12_int8_conv_cu_97cede94{}\n"
    text = (head.format("25int8_conv3x3_wgmma_kernelILi1EEEv14CUtensorMap_st")
            + "  IGMMA.64x208x32.S8.S8 R24, gdesc[UR4], R24 ;\n  UTMALDG.2D [UR8], [UR10] ;\n"
            + head.format("26int8_conv3x3_gather_kernelILb0EEEvPKa") + "  IMMA.16832.S8.S8 R4, R8, R12, R4 ;\n"
            + head.format("24int8_conv3x3_cin1_kernelILb1EEEvPKa") + "  IDP.4A.S8.S8 R2, R3, R4, RZ ;\n")
    monkeypatch.setattr(int8_ab.subprocess, "run", lambda *a, **k: type("Proc", (), {"stdout": text})())
    from l3embedding_torch.ops import cuda_build

    monkeypatch.setattr(cuda_build, "build", lambda name: "lib.so")
    got = int8_ab.library_sass()
    assert got == {
        "int8_conv3x3_wgmma_kernel<1>": {"IGMMA": 1, "IMMA": 0, "UTMALDG": 1, "IDP": 0},
        "int8_conv3x3_gather_kernel<0>": {"IGMMA": 0, "IMMA": 1, "UTMALDG": 0, "IDP": 0},
        "int8_conv3x3_cin1_kernel<1>": {"IGMMA": 0, "IMMA": 0, "UTMALDG": 0, "IDP": 1},
    }
