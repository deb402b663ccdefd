"""The PyTorch port's block-1 probe kernels against the JAX spike.

``tools/pallas_block1_spike.py`` is run as it is, its Pallas kernels in TPU
interpret mode: ``pallas_call`` is patched here to add ``interpret=`` and to
record each kernel with its keyword arguments, which are then run again on
the seeded inputs that the port's wrappers get. On the CPU the wrappers
(``ops.block1_kernel``) run their plain versions; the CUDA kernels are
checked on the card by ``chip_smoke.py`` and by the ``cuda``-marked tests
below.

Gate for bf16 outputs, kernel or plain version against a reference:
max |Δ| / max |ref| ≤ 1e-2 and flattened cosine ≥ 0.99999. Both sides take
exact bf16 products into f32 sums in another order, so they differ by at
most a bf16 rounding of the output (2^-8 relative).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from l3embedding_torch.compat.from_jax import block1_conv_from_jax
from l3embedding_torch.ops import block1_kernel, cuda_build
from l3embedding_torch.tools import block1_spike
from tools import pallas_block1_spike as spike
from torch_port_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


def _gate(ours, theirs):
    ours, theirs = (np.asarray(v, np.float64).ravel() for v in (ours, theirs))
    assert ours.shape == theirs.shape
    rel = np.abs(ours - theirs).max() / np.abs(theirs).max()
    cos = (ours @ theirs) / (np.linalg.norm(ours) * np.linalg.norm(theirs))
    assert rel <= 1e-2 and cos >= 0.99999, (rel, cos)


def _f32(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _bf16(t: torch.Tensor):
    return jnp.asarray(_f32(t), jnp.bfloat16)


@pytest.fixture
def pallas_calls(monkeypatch):
    """Run the spike's pallas_calls in TPU interpret mode; yield a function
    that re-runs the last recorded (kernel, kwargs) on new operands."""
    calls = []
    orig = pl.pallas_call

    def interpret_call(kernel, **kw):
        calls.append((kernel, kw))
        return orig(kernel, **kw, interpret=pltpu.InterpretParams())

    monkeypatch.setattr(pl, "pallas_call", interpret_call)

    def rerun_last(*operands):
        kernel, kw = calls[-1]
        return kernel, np.asarray(interpret_call(kernel, **kw)(*operands), np.float32)

    return rerun_last


@pytest.mark.parametrize("n_out", [64, 128])
def test_gemm_plain_version_matches_pallas_kernel(pallas_calls, n_out):
    """(a) gemm_probe_ref against bench_gemm's kernel at reps = 2, on
    bench_gemm's RandomState(0) operands."""
    spike.bench_gemm(1, 1, reps=2, n_out=n_out)
    a, w, s, b = block1_spike.gemm_operands(n_out, CPU)
    _, theirs = pallas_calls(_bf16(a), _bf16(w), jnp.asarray(s.numpy()), jnp.asarray(b.numpy()))
    ours = block1_kernel.gemm_probe(a, w, s, b, reps=2)
    assert ours.shape == (3584, n_out) and ours.dtype == torch.bfloat16
    _gate(_f32(ours), theirs)


def test_conv_plain_version_matches_pallas_fused_kernel(pallas_calls):
    """(b) conv3x3_bn_relu_ref against _fused_kernel at batch 2 on the spike's
    _inputs, with the weights through block1_conv_from_jax (the Pallas kernel
    gets the spike wrapper's padded x)."""
    spike.bench_fused(2, 1)
    x, w, scale, shift = spike._inputs(2)
    xp = jnp.pad(jnp.asarray(x, jnp.bfloat16), ((0, 0), (1, 1), (1, 7), (0, 64)))
    kernel, theirs = pallas_calls(
        xp, jnp.asarray(w.reshape(576, 64), jnp.bfloat16),
        jnp.asarray(scale.reshape(1, 64)), jnp.asarray(shift.reshape(1, 64)),
    )
    assert kernel is spike._fused_kernel
    ops = block1_conv_from_jax(w, scale, shift)
    ours = block1_kernel.conv3x3_bn_relu(
        torch.from_numpy(x).to(torch.bfloat16), ops["w"], ops["scale"], ops["shift"])
    assert ours.shape == (2, 224, 224, 64) and ours.dtype == torch.bfloat16
    _gate(_f32(ours), theirs)


@pytest.mark.parametrize("shape", [(1, 257, 197), (2, 13, 9)])
def test_conv_plain_version_matches_xla_formulation(shape):
    """(c) conv3x3_bn_relu_ref against the spike's `ref` formula
    (conv_general_dilated SAME, f32 accumulation) at the audio conv1_2 shape,
    which _fused_kernel cannot take, and at a small one whose tiles are all
    edge."""
    rng = np.random.RandomState(1)
    x = rng.randn(*shape, 64).astype(np.float32) * 0.1
    w = rng.randn(3, 3, 64, 64).astype(np.float32) * 0.05
    scale = rng.rand(64).astype(np.float32) + 0.5
    shift = rng.randn(64).astype(np.float32) * 0.1
    y = jax.lax.conv_general_dilated(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.float32,
    )
    theirs = np.asarray(jnp.maximum(y * scale + shift, 0.0).astype(jnp.bfloat16), np.float32)
    ops = block1_conv_from_jax(w, scale, shift)
    ours = block1_kernel.conv3x3_bn_relu(
        torch.from_numpy(x).to(torch.bfloat16), ops["w"], ops["scale"], ops["shift"])
    assert ours.shape == (*shape, 64)
    _gate(_f32(ours), theirs)


def test_tool_cpu_run_prints_the_spike_variants(capsys):
    """(d) the tool's `all` prints one JSON line per variant with the spike's
    fields; on the CPU the fused check compares the plain version with
    itself."""
    results = block1_spike.main(["all", "--batch", "1", "--steps", "1", "--device", "cpu"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert lines == results
    assert [r["variant"] for r in lines] == [
        "cudnn_conv_bn_relu", "hopper_gemm_smem_n64", "hopper_gemm_smem_n128",
        "hopper_fused_conv_bn_relu",
    ]
    for r in lines:
        assert r["ms"] > 0 and r["tflops"] > 0 and r["device"] == "cpu"
    assert lines[1]["reps"] == lines[2]["reps"] == 64
    assert lines[3]["max_abs_err"] == 0.0 and lines[3]["rel_err"] == 0.0


def test_weight_layouts_agree():
    """block1_conv_from_jax: the kernel layout's rows are (dy, dx, ci) of the
    HWIO kernel, and cuDNN's OIHW copy gives the same conv (the CPU yardstick
    against the plain version)."""
    rng = np.random.RandomState(2)
    w = rng.randn(3, 3, 64, 64).astype(np.float32) * 0.05
    scale, shift = rng.rand(64).astype(np.float32) + 0.5, rng.randn(64).astype(np.float32)
    ops = block1_conv_from_jax(w, scale, shift)
    assert ops["w"].shape == (576, 64) and ops["w_oihw"].shape == (64, 64, 3, 3)
    np.testing.assert_array_equal(_f32(ops["w"])[(1 * 3 + 2) * 64 + 5], _f32(ops["w_oihw"])[:, 5, 1, 2])
    x = torch.from_numpy(rng.randn(1, 11, 7, 64).astype(np.float32)).to(torch.bfloat16)
    ref = block1_kernel.conv3x3_bn_relu_ref(x, ops["w"], ops["scale"], ops["shift"])
    lib = block1_spike.cudnn_conv_bn_relu(x, ops["w_oihw"], ops["scale"], ops["shift"])
    _gate(_f32(lib), _f32(ref))
    with pytest.raises(ValueError, match="HWIO"):
        block1_conv_from_jax(w[:, :, :32], scale, shift)


def test_gemm_nudge_is_the_identity_in_bf16():
    """The CUDA GEMM drops the spike's per-rep nudge bf16(f32(w)·(1 + i·1e-8)):
    over bench_gemm's weights it returns w bit for bit for every rep it runs,
    and up to 1.9e5."""
    _, w, _, _ = block1_spike.gemm_operands(128, CPU)
    for i in list(range(64)) + [1000, 190000]:
        fac = 1.0 + torch.tensor(float(i), dtype=torch.float32) * 1e-8
        assert torch.equal((w.float() * fac).to(torch.bfloat16), w), i


def test_wrappers_check_their_input():
    a, w, s, b = block1_spike.gemm_operands(64, CPU)
    with pytest.raises(ValueError, match="unsupported device"):
        block1_kernel.gemm_probe(a.to("meta"), w.to("meta"), s.to("meta"), b.to("meta"))
    with pytest.raises(ValueError, match="K a multiple of 64"):
        block1_kernel.gemm_probe(a[:, :560], w[:560], s, b)
    with pytest.raises(ValueError, match="64|128"):
        block1_kernel.gemm_probe(a, w[:, :32], s[:, :32], b[:, :32])
    with pytest.raises(ValueError, match="reps"):
        block1_kernel.gemm_probe(a, w, s, b, reps=0)
    with pytest.raises(ValueError, match="float32"):
        block1_kernel.gemm_probe_ref(a, w, s.double(), b, reps=1)
    x = torch.zeros(1, 5, 5, 64, dtype=torch.bfloat16)
    wc, sc = torch.zeros(576, 64, dtype=torch.bfloat16), torch.ones(64)
    with pytest.raises(ValueError, match=r"\(B, H, W, 64\) bfloat16"):
        block1_kernel.conv3x3_bn_relu(x.float(), wc, sc, sc)
    with pytest.raises(ValueError, match=r"w \(576, 64\)"):
        block1_kernel.conv3x3_bn_relu(x, wc.T, sc, sc)
    with pytest.raises(ValueError, match="64 float32"):
        block1_kernel.conv3x3_bn_relu_ref(x, wc, sc[:32], sc)
    assert [p.name for p in cuda_build.source_files(cuda_build.CSRC / "block1_conv.cu")] == [
        "block1_conv.cu"]


def _cuda_or_skip(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)


@pytest.mark.cuda
@pytest.mark.parametrize("n_out", [64, 128])
def test_cuda_gemm_matches_plain_version(n_out, monkeypatch):
    _cuda_or_skip(monkeypatch)
    a, w, s, b = block1_spike.gemm_operands(n_out, torch.device("cuda"))
    block1_kernel.LAUNCHES.clear()
    got = block1_kernel.gemm_probe(a, w, s, b, reps=8)
    assert block1_kernel.LAUNCHES["block1_gemm"] == 1
    want = block1_kernel.gemm_probe_ref(a, w, s, b, reps=8)
    _gate(_f32(got.cpu()), _f32(want.cpu()))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 224, 224), (1, 257, 197), (1, 13, 9)])
def test_cuda_conv_matches_plain_version(shape, monkeypatch):
    _cuda_or_skip(monkeypatch)
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(*shape, 64).astype(np.float32) * 0.1)
    w = torch.from_numpy(rng.randn(576, 64).astype(np.float32) * 0.05)
    scale = torch.from_numpy(rng.rand(64).astype(np.float32) + 0.5).cuda()
    shift = torch.from_numpy(rng.randn(64).astype(np.float32) * 0.1).cuda()
    x, w = x.to(torch.bfloat16).cuda(), w.to(torch.bfloat16).cuda()
    block1_kernel.LAUNCHES.clear()
    got = block1_kernel.conv3x3_bn_relu(x, w, scale, shift)
    assert block1_kernel.LAUNCHES["block1_conv"] == 1
    want = block1_kernel.conv3x3_bn_relu_ref(x, w, scale, shift)
    _gate(_f32(got.cpu()), _f32(want.cpu()))


# ---------------------------------------------------------------------------
# The wgmma kernels' schedule, modelled in numpy (csrc/block1_conv.cu). TMA's
# 128-byte swizzle, and wgmma's reading of a swizzled operand through its
# descriptor, are modelled by the hardware's rule on shared-memory byte
# offsets from a 1024-byte aligned base (bits 4-6 XOR bits 7-9); the
# kernels' own ldmatrix / stmatrix addresses use their formula
# (`swizzled`), which the model goes through, so a mismatch between the two
# shows as wrong values.

ROW = block1_kernel.SWIZZLE_BYTES  # a pixel (64 bf16 channels) or a W row
TH, TW = block1_kernel.TILE_H, block1_kernel.TILE_W
SH, SW = TH + 2, TW + 2
STAGE_BYTES = -(-SH * SW * ROW // 1024) * 1024


def _tma_swizzle(offset):
    """Where the 128-byte swizzle puts byte `offset` of a box."""
    return offset ^ (((offset >> 7) & 7) << 4)


def _kernel_swizzle(row, chunk):
    """The kernels' `swizzled(base, row, chunk)`: chunk `chunk` of `row`."""
    return row * ROW + ((chunk ^ (row & 7)) << 4)


def _tma_box(x, b, h0, w0, bh, bw):
    """A TMA box (bh, bw, 64) of x (B, H, W, 64) at (b, h0, w0): zeros
    outside the tensor, negative origins included."""
    _, h, w, c = x.shape
    out = np.zeros((bh, bw, c), x.dtype)
    hs, ws, he, we = max(h0, 0), max(w0, 0), min(h0 + bh, h), min(w0 + bw, w)
    if hs < he and ws < we:
        out[hs - h0:he - h0, ws - w0:we - w0] = x[b, hs:he, ws:we]
    return out


def _to_smem(rows):
    """Rows of 64 values (128 bytes) as TMA writes them into shared memory."""
    flat = rows.reshape(-1)
    img = np.zeros(flat.size, flat.dtype)
    img[_tma_swizzle(np.arange(flat.size) * 2) // 2] = flat
    return img


def _operand_index(first_row, n_rows, k0):
    """Where wgmma reads through a K-major descriptor that starts at row
    `first_row`, 2·k0 bytes in: rows first_row.. of 16 values from k0, at
    the swizzled addresses (base offset 0, any row); element indices."""
    logical = (first_row + np.arange(n_rows))[:, None] * ROW + (k0 + np.arange(16))[None, :] * 2
    return _tma_swizzle(logical) // 2


def _ldmatrix_trans_w(w_img, t):
    """Each lane's 4 W^T fragment registers of k16 step t, read by the
    kernel's ldmatrix.trans addresses (lane l gives row 16t + (l & 7) +
    8·(l >> 4), chunk 2·warp + ((l >> 3) & 1)), for the four warps: a
    (warp, lane, register, 2) array of (channel, k) values."""
    out = np.zeros((4, 32, 4, 2), w_img.dtype)
    lanes = np.arange(32)
    for warp in range(4):
        rows = 16 * t + (lanes & 7) + 8 * (lanes >> 4)
        addr = _kernel_swizzle(rows, 2 * warp + ((lanes >> 3) & 1))
        mats = [w_img[(addr[8 * i:8 * i + 8, None] + np.arange(8) * 2) // 2] for i in range(4)]
        g, q = lanes >> 2, lanes & 3
        for i, m in enumerate(mats):  # .trans: lane (g, q) gets (row 2q, col g), (2q + 1, g)
            out[warp, :, i] = np.stack([m[2 * q, g], m[2 * q + 1, g]], 1)
    return out


def _conv_tiles(batch, h, w):
    """The kernel's tile walk: tile t → (b, h0, w0), columns fastest."""
    tiles_w, tiles_h = -(-w // TW), -(-h // TH)
    return [(t // (tiles_h * tiles_w), (t % (tiles_h * tiles_w)) // tiles_w * TH,
             (t % tiles_w) * TW) for t in range(batch * tiles_h * tiles_w)]


def _conv_schedule():
    """An output row's wgmma in issue order: (dy, dx, kc, accumulate)."""
    for dy in range(3):
        for dx in range(3):
            for kc in range(4):
                yield dy, dx, kc, (dy | dx | kc) != 0


def _epilogue_index(r):
    """(64 channels, TW pixels) → where output row r lands in the staging
    tile (element index): the kernel's stmatrix.trans, matrix mat of warp v
    and pixel-block pair j holding channels 16v + 8·(mat & 1).. and pixels
    8·(j + (mat >> 1)).., stored transposed at the rows lanes 8·mat.. give."""
    idx = np.full((64, TW), -1)
    lanes = np.arange(32)
    for v in range(4):
        for j in range(0, TW // 8, 2):
            for mat in range(4 if j + 1 < TW // 8 else 2):
                ln = lanes[8 * mat:8 * mat + 8]
                addr = _kernel_swizzle(r * TW + 8 * (j + (mat >> 1)) + (ln & 7), 2 * v + (mat & 1))
                chans = 16 * v + 8 * (mat & 1) + np.arange(8)
                pix = 8 * (j + (mat >> 1)) + np.arange(8)
                idx[np.ix_(chans, pix)] = ((addr[:, None] + np.arange(8)[None, :] * 2) // 2).T
    assert (idx >= 0).all()
    return idx


def _conv_model(x, w, scale, shift, n_ctas=5):
    """The conv kernel's work split in numpy: persistent CTAs walk the tiles
    (tile c + i·n_ctas, warpgroup i & 1, stage i % STAGES); W^T's fragments
    come from ldmatrix.trans over W as TMA laid it down; each slab comes from
    one zero-filled TMA box, and each output row's 36 products read it
    through descriptors at the shifted pixel; the epilogue's stmatrix.trans
    addresses fill the staging tile, which the store box reads back, clipped
    to the image."""
    batch, h, wd, _ = x.shape
    w_img = _to_smem(w)
    # W^T (64 channels × 16 k) of step t from the fragments: lane (g, q) of
    # warp v holds channels 16v + g (+8 in registers 1, 3), k 2q, 2q + 1 (+8 in
    # registers 2, 3).
    g, q = np.arange(32) >> 2, np.arange(32) & 3
    wt = np.zeros((36, 64, 16), np.float64)
    for t in range(36):
        frag = _ldmatrix_trans_w(w_img, t)
        for v in range(4):
            for reg, (dc, dk) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
                for e in range(2):
                    wt[t, 16 * v + g + dc, 2 * q + dk + e] = frag[v, :, reg, e]
    # What each product of output row r reads (through its descriptor), and
    # where the row's outputs go in the staging tile.
    reads = [[_operand_index((r + dy) * SW + dx, TW, 16 * kc) for dy, dx, kc, _ in _conv_schedule()]
             for r in range(TH)]
    epilogue = [_epilogue_index(r) for r in range(TH)]
    accumulates = [acc for *_, acc in _conv_schedule()]
    y = np.zeros(x.shape, np.float32)
    written = np.zeros(x.shape[:3], np.int64)
    tiles = _conv_tiles(batch, h, wd)
    for cta in range(min(n_ctas, len(tiles))):
        for t in range(cta, len(tiles), n_ctas):
            b, h0, w0 = tiles[t]
            img = _to_smem(_tma_box(x, b, h0 - 1, w0 - 1, SH, SW)).astype(np.float64)
            staged = np.zeros(TH * TW * 64, np.float32)
            for r in range(TH):
                acc = None
                for step, accumulate in enumerate(accumulates):
                    prod = wt[step] @ img[reads[r][step]].T
                    acc = acc + prod if accumulate else prod
                staged[epilogue[r]] = np.maximum(acc * scale[:, None] + shift[:, None], 0.0)
            box = staged[_tma_swizzle(np.arange(staged.size) * 2) // 2].reshape(TH, TW, 64)
            hh, ww = min(TH, h - h0), min(TW, wd - w0)
            y[b, h0:h0 + hh, w0:w0 + ww] = box[:hh, :ww]
            written[b, h0:h0 + hh, w0:w0 + ww] += 1
    return y, written


def _conv_inputs(shape, seed=4):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(*shape, 64).astype(np.float32) * 0.1).to(torch.bfloat16)
    w = torch.from_numpy(rng.randn(576, 64).astype(np.float32) * 0.05).to(torch.bfloat16)
    return x, w, rng.rand(64).astype(np.float32) + 0.5, rng.randn(64).astype(np.float32) * 0.1


def test_schedule_constants_match_the_source():
    import re

    src = (cuda_build.CSRC / "block1_conv.cu").read_text()
    consts = {m[0]: int(m[1]) for m in re.findall(r"\b([A-Z_]+) = (\d+)\b", src)}
    assert (consts["TH"], consts["TW"]) == (TH, TW)
    assert consts["STAGES"] == block1_kernel.STAGES
    assert consts["GEMM_SPLIT"] == block1_kernel.GEMM_SPLIT
    assert consts["GEMM_KC"] == block1_kernel.GEMM_K_PASS
    # W (then the two output tiles), the ring and the barriers fit the 227 KB
    # a block gets; the vision width 224 is whole tiles.
    assert 1024 + 576 * ROW + block1_kernel.STAGES * STAGE_BYTES + 7 * 8 <= 232448
    assert 2 * TH * TW * ROW <= 576 * ROW
    assert 224 % TW == 0


@pytest.mark.parametrize("shape", [(1, 13, 9), (2, 19, 70), (1, 11, 197), (2, 4, 64), (1, 257, 5)])
@pytest.mark.parametrize("n_ctas", [1, 3, 132])
def test_conv_tile_walk_writes_every_pixel_once(shape, n_ctas):
    """Persistent CTAs over the tile walk, stores clipped to the image: each
    output pixel is written exactly once, H and W no multiple of the tile."""
    batch, h, w = shape
    tiles = _conv_tiles(batch, h, w)
    count = np.zeros(shape, np.int64)
    for cta in range(min(n_ctas, len(tiles))):
        for t in range(cta, len(tiles), n_ctas):
            b, h0, w0 = tiles[t]
            count[b, h0:h0 + TH, w0:w0 + TW] += 1
    assert (count == 1).all()


def test_tma_boxes_outside_the_image_read_zeros():
    """The slab box at (h0 − 1, w0 − 1): the halo row and column before the
    image, and the columns past a 197-wide row, come back as zeros; the
    rest is the image."""
    x = np.arange(2 * 7 * 197 * 64, dtype=np.float32).reshape(2, 7, 197, 64) + 1
    box = _tma_box(x, 1, -1, 167, SH, SW)
    assert (box[0] == 0).all() and (box[:, 30:] == 0).all()
    np.testing.assert_array_equal(box[1:, :30], x[1, :SH - 1, 167:197])
    assert (_tma_box(x, 0, 7, 0, SH, SW) == 0).all()  # a box wholly past the last row
    assert (_tma_box(x, 0, -SH, -SW, SH, SW) == 0).all()


def test_swizzle_addresses_read_back_pixel_and_channel():
    """The kernels' address of (row, chunk) is where the 128-byte swizzle
    put it, in a slab and in W (stage bases stay 1024-aligned); a descriptor
    started at any pixel of the slab, at each 16-channel step, reads that
    pixel's channels; the ldmatrix.trans addresses give each lane W^T's
    fragment; the stmatrix rows of one 8×8 matrix (8 pixels, one chunk) and
    the ldmatrix rows of W touch distinct banks."""
    rows, chunks = np.meshgrid(np.arange(SH * SW), np.arange(8), indexing="ij")
    assert (_kernel_swizzle(rows, chunks) == _tma_swizzle(rows * ROW + chunks * 16)).all()
    assert STAGE_BYTES % 1024 == 0 and (576 * ROW) % 1024 == 0 and (TH * TW * ROW) % 1024 == 0
    slab = np.random.RandomState(0).randn(SH, SW, 64).astype(np.float32)
    img = _to_smem(slab)
    for s, dx, kc in ((0, 0, 0), (1, 2, 3), (SH - 1, 1, 2), (3, 2, 1)):
        np.testing.assert_array_equal(img[_operand_index(s * SW + dx, TW, 16 * kc)],
                                      slab[s, dx:dx + TW, 16 * kc:16 * kc + 16])
    w = np.random.RandomState(1).randn(576, 64).astype(np.float32)
    frag = _ldmatrix_trans_w(_to_smem(w), 5)
    g, q = np.arange(32) >> 2, np.arange(32) & 3
    for v in range(4):
        for reg, (dc, dk) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
            np.testing.assert_array_equal(frag[v, :, reg, 0], w[80 + 2 * q + dk, 16 * v + g + dc])
            np.testing.assert_array_equal(frag[v, :, reg, 1], w[80 + 2 * q + dk + 1, 16 * v + g + dc])
    for first in range(0, SH * SW - 8):
        banks = (_kernel_swizzle(np.arange(first, first + 8), 3) // 16) % 8
        assert len(set(banks)) == 8


def test_each_output_row_takes_every_tap_once():
    """One output row's 36 wgmma: every (tap, 16-channel step) once, the
    first overwriting the accumulator (accumulate = 0), tap (dy, dx) at
    descriptor offset (dy·SW + dx)·128 + 32·kc from the row's start."""
    sched = list(_conv_schedule())
    assert len({(dy, dx, kc) for dy, dx, kc, _ in sched}) == len(sched) == 36
    assert [acc for *_, acc in sched] == [False] + [True] * 35


@pytest.mark.parametrize("shape", [(1, 13, 9), (2, 19, 70), (1, 9, 197), (1, 6, 112)])
def test_conv_model_matches_plain_version(shape):
    """The numpy model of the kernel's schedule against conv3x3_bn_relu_ref
    (f32 conv2d) at edge shapes: all tiles edge, H and W no multiple of the
    tile, the audio width 197 cut to 9 rows, a width of whole tiles."""
    x, w, scale, shift = _conv_inputs(shape)
    y, written = _conv_model(_f32(x), _f32(w), scale, shift)
    assert (written == 1).all()
    ref = block1_kernel.conv3x3_bn_relu_ref(x, w, torch.from_numpy(scale), torch.from_numpy(shift))
    _gate(torch.from_numpy(y).to(torch.bfloat16).float().numpy(), _f32(ref))


def test_conv_model_matches_pallas_fused_kernel(pallas_calls):
    """The model against the spike's _fused_kernel in interpret mode on the
    spike's batch-2 check inputs (224 × 224: four 56-pixel blocks a row)."""
    spike.bench_fused(2, 1)
    x, w, scale, shift = spike._inputs(2)
    xp = jnp.pad(jnp.asarray(x, jnp.bfloat16), ((0, 0), (1, 1), (1, 7), (0, 64)))
    _, theirs = pallas_calls(
        xp, jnp.asarray(w.reshape(576, 64), jnp.bfloat16),
        jnp.asarray(scale.reshape(1, 64)), jnp.asarray(shift.reshape(1, 64)),
    )
    ops = block1_conv_from_jax(w, scale, shift)
    xb = _f32(torch.from_numpy(x).to(torch.bfloat16))
    y, written = _conv_model(xb, _f32(ops["w"]), ops["scale"].numpy(), ops["shift"].numpy(), n_ctas=132)
    assert (written == 1).all()
    _gate(torch.from_numpy(y).to(torch.bfloat16).float().numpy(), theirs)


def _gemm_model(a, w, s, b, reps):
    """The GEMM probe's split in numpy: 64-row tiles, each over a cluster of
    GEMM_SPLIT CTAs with reps [r·reps/S, (r+1)·reps/S); K in passes of
    GEMM_K_PASS, zero-filled past k; the last CTA's f32 sums added to the
    first's, then ·s + b, ReLU, bf16."""
    m, k = a.shape
    split, kp = block1_kernel.GEMM_SPLIT, block1_kernel.GEMM_K_PASS
    a64, w64 = a.astype(np.float64), w.astype(np.float64)
    out = np.zeros((m, w.shape[1]), np.float32)
    covered = np.zeros(reps, np.int64)
    for row0 in range(0, m, block1_kernel.GEMM_M_TILE):
        rows = slice(row0, min(row0 + block1_kernel.GEMM_M_TILE, m))
        partial = []
        for rank in range(split):
            lo, hi = rank * reps // split, (rank + 1) * reps // split
            if row0 == 0:
                covered[lo:hi] += 1
            acc = np.zeros((rows.stop - rows.start, w.shape[1]))
            for k0 in range(0, k, kp):
                a_pass = np.zeros((acc.shape[0], kp))
                w_pass = np.zeros((kp, w.shape[1]))
                a_pass[:, :min(kp, k - k0)] = a64[rows, k0:k0 + kp]
                w_pass[:min(kp, k - k0)] = w64[k0:k0 + kp]
                for _ in range(lo, hi):
                    acc += a_pass @ w_pass
            partial.append(acc)
        out[rows] = np.maximum(sum(partial) * s + b, 0.0)
    assert (covered == 1).all()
    return out


@pytest.mark.parametrize("n_out", [64, 128])
@pytest.mark.parametrize("m, k, reps", [(3584, 576, 2), (200, 704, 3), (100, 448, 1)])
def test_gemm_model_matches_plain_version(n_out, m, k, reps):
    """The rep split and its reduction, the K passes and the row tail
    against gemm_probe_ref: bench_gemm's operands, cut or widened."""
    a, w, s, b = block1_spike.gemm_operands(n_out, CPU)
    a = torch.cat([a, a[:, :128]], 1)[:m, :k].contiguous()
    w = torch.cat([w, w[:128]], 0)[:k].contiguous()
    ours = _gemm_model(_f32(a), _f32(w), s.numpy(), b.numpy(), reps)
    want = block1_kernel.gemm_probe_ref(a, w, s, b, reps)
    _gate(torch.from_numpy(ours).to(torch.bfloat16).float().numpy(), _f32(want))


def test_sass_counts_by_kernel_function():
    """block1_spike.sass_opcodes on cuobjdump-style text: counts per kernel
    function, the template argument kept in the name."""
    text = """
        Function : _ZN47_GLOBAL__N__b1_block1_gemm_kernelILi64EEEv14CUtensorMap_st
        /*0010*/   UTMALDG.2D [UR8], [UR4] ;
        /*0020*/   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], R24 ;
        /*0030*/   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR8], R24, gsb0 ;
        Function : _ZN47_GLOBAL__N__b1_block1_conv_kernelE14CUtensorMap_st
        /*0010*/   LDSM.16.M88.4 R4, [R2] ;
        /*0020*/   UTMASTG.4D [UR4], [UR8] ;
        /*0030*/   HMMA.16816.F32.BF16 R8, R4, R6, R8 ;
    """
    got = block1_spike.sass_opcodes(text)
    assert set(got) == {"block1_gemm_kernel<64>", "block1_conv_kernel"}
    assert got["block1_gemm_kernel<64>"]["HGMMA"] == 2 and got["block1_gemm_kernel<64>"]["UTMALDG"] == 1
    assert got["block1_conv_kernel"] == dict(HGMMA=0, HMMA=1, UTMALDG=0, UTMASTG=1, UBLKCP=0, LDSM=1)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 224, 224), (2, 257, 197), (3, 5, 200), (1, 66, 63), (1, 7, 57)])
def test_cuda_conv_at_edge_shapes_and_more_tiles_than_sms(shape, monkeypatch):
    """(4, 224, 224) gives 896 tiles and (2, 257, 197) 520, more than the
    132 SMs: every CTA runs several tiles through the ring and both
    warpgroups (the register-A hazard showed only with more work than SMs
    in the front ends). Widths 200, 63 and 57 leave a ragged last tile."""
    _cuda_or_skip(monkeypatch)
    x, w, scale, shift = _conv_inputs(shape, seed=5)
    x, w = x.cuda(), w.cuda()
    scale, shift = torch.from_numpy(scale).cuda(), torch.from_numpy(shift).cuda()
    got = block1_kernel.conv3x3_bn_relu(x, w, scale, shift)
    want = block1_kernel.conv3x3_bn_relu_ref(x, w, scale, shift)
    _gate(_f32(got.cpu()), _f32(want.cpu()))


@pytest.mark.cuda
@pytest.mark.parametrize("n_out", [64, 128])
@pytest.mark.parametrize("m, k, reps", [(3584, 576, 64), (200, 704, 3), (1000, 448, 1)])
def test_cuda_gemm_rep_split_and_k_passes(n_out, m, k, reps, monkeypatch):
    _cuda_or_skip(monkeypatch)
    a, w, s, b = block1_spike.gemm_operands(n_out, torch.device("cuda"))
    a = torch.cat([a, a[:, :128]], 1)[:m, :k].contiguous()
    w = torch.cat([w, w[:128]], 0)[:k].contiguous()
    got = block1_kernel.gemm_probe(a, w, s, b, reps)
    _gate(_f32(got.cpu()), _f32(block1_kernel.gemm_probe_ref(a, w, s, b, reps).cpu()))


@pytest.mark.cuda
def test_cuda_kernels_on_a_second_device(monkeypatch):
    """Both kernels on cuda:1 after cuda:0: the tensor maps, the shared-
    memory limit and the launch follow the tensors' device."""
    _cuda_or_skip(monkeypatch)
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    x, w, scale, shift = _conv_inputs((2, 30, 70), seed=6)
    scale, shift = torch.from_numpy(scale), torch.from_numpy(shift)
    a, wg, s, b = block1_spike.gemm_operands(64, CPU)
    for dev in ("cuda:0", "cuda:1"):
        got = block1_kernel.conv3x3_bn_relu(x.to(dev), w.to(dev), scale.to(dev), shift.to(dev))
        assert got.device == torch.device(dev)
        _gate(_f32(got.cpu()), _f32(block1_kernel.conv3x3_bn_relu_ref(x, w, scale, shift)))
        got = block1_kernel.gemm_probe(a.to(dev), wg.to(dev), s.to(dev), b.to(dev), 4)
        _gate(_f32(got.cpu()), _f32(block1_kernel.gemm_probe_ref(a, wg, s, b, 4)))
