"""Train-mode BatchNorm's kernel (``ops/bn_kernel.py``, ``csrc/bn_train.cu``).

On the CPU: the plain version of the kernel's four passes (``bn_train`` on a
CPU tensor: ``forward_ref`` and the closed-form ``backward_ref``) against
float64 autograd of the written-out ``towers._bn_f32``, and against f32
autograd of it where the variance is clipped at 0; under sync BN, on two
gloo ranks (``tests/torch_port_bn_sync_worker.py``), against the
written-out sync BN. On the card (``-m cuda``): the kernel against the plain
version, run for run repeatable, a cnn_L3_melspec2 bf16 train step that
sends all 18 BatchNorms through it, and the kernel under sync BN on two
ranks (gloo on one card, NCCL on two). No JAX here, so that the file
collects on the machine with the card.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from l3embedding_torch.models import towers
from l3embedding_torch.ops import bn_kernel
from l3embedding_torch.utils import trace
from torch_port_bn_sync_worker import CASES as SYNC_CASES
from torch_port_bn_sync_worker import LIMITS as SYNC_LIMITS
from torch_port_threads import one_torch_thread  # noqa: F401

EPS = 1e-3
HERE = os.path.dirname(os.path.abspath(__file__))


def _layer(c, seed=0, dtype=torch.float32, device="cpu"):
    """A BatchNorm2d with seeded γ, β and running statistics."""
    g = torch.Generator().manual_seed(seed)
    bn = torch.nn.BatchNorm2d(c, eps=EPS)
    with torch.no_grad():
        bn.weight.copy_(1 + 0.1 * torch.randn(c, generator=g))
        bn.bias.copy_(0.05 * torch.randn(c, generator=g))
        bn.running_mean.copy_(torch.randn(c, generator=g))
        bn.running_var.copy_(1 + torch.rand(c, generator=g))
    return bn.to(dtype).to(device)


def _plain(bn, x, out_dtype=torch.float32):
    return bn_kernel.bn_train(x, bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps,
                              towers.BN_MOMENTUM, out_dtype)


def _grads(fn, bn, x0, dy, need_dx=True):
    """fn(bn, x) → y, then (y·dy).sum() backward → (y, dx or None, dγ, dβ)."""
    x = x0.clone().requires_grad_(need_dx)
    y = fn(bn, x)
    (y.double() * dy).sum().backward()
    return y.detach(), x.grad, bn.weight.grad, bn.bias.grad


def _written_out(bn, x):
    return towers._bn_f32(bn, x, True)[0]


def _rel(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm())


SHAPES = [
    ((2, 3, 224, 224), 0.57, 0.0),  # the vision input BN
    ((2, 1, 256, 199), 15.0, -40.0),  # the audio input BN on dB mels
    ((2, 64, 224, 224), 1.0, 0.5),  # a block-1 BN
]


def _case(shape, scale, offset):
    torch.manual_seed(0)
    x0 = torch.randn(*shape) * scale + offset
    dy = (torch.randn(*shape) * 1e-3 + 1e-4).double()
    return x0, dy


@pytest.mark.parametrize("shape,scale,offset", SHAPES, ids=["vision_input", "audio_input", "block1"])
def test_plain_version_vs_float64(shape, scale, offset):
    """The plain version in f32: y, dx, dγ and dβ within 3e-5 relative of
    float64 autograd of the written-out BN (the bound of
    test_torch_port_train.py::test_bn_train_grads_vs_float64)."""
    x0, dy = _case(shape, scale, offset)
    c = shape[1]
    ref = _grads(_written_out, _layer(c, dtype=torch.float64), x0.double(), dy)
    ours = _grads(_plain, _layer(c), x0, dy)
    errs = [_rel(a, r) for a, r in zip(ours, ref)]
    print(f"BN {shape}: y, dx, dscale, dbias relative error vs float64: {['%.2e' % e for e in errs]}")
    assert max(errs) <= 3e-5


@pytest.mark.parametrize("shape,scale,offset", SHAPES[:2], ids=["vision_input", "audio_input"])
def test_plain_version_input_takes_no_gradient(shape, scale, offset, monkeypatch):
    """An input BN, whose x takes no gradient: the backward skips dx (the
    plain version is asked for none), x.grad stays None, and dγ and dβ are
    float64's within 3e-5."""
    x0, dy = _case(shape, scale, offset)
    c = shape[1]
    asked = []
    real = bn_kernel.grad_x_ref
    monkeypatch.setattr(bn_kernel, "grad_x_ref",
                        lambda *a: asked.append(a[-1]) or real(*a))
    ref = _grads(_written_out, _layer(c, dtype=torch.float64), x0.double(), dy, need_dx=False)
    y, dx, dw, db = _grads(_plain, _layer(c), x0, dy, need_dx=False)
    assert asked == [False] and dx is None
    assert max(_rel(dw, ref[2]), _rel(db, ref[3])) <= 3e-5


def test_plain_version_clipped_variance():
    """A constant channel (variance 0) and one constant but for a ripple far
    under its mean's rounding, whose E[x²] − E[x]² comes out below 0 in f32
    and is clipped: dx there is the closed form's first term alone,
    mul·(dy − Σdy/M), as f32 autograd of the written-out BN gives it (its
    clamp passes no gradient below 0), within 1e-5; with the variance term
    kept the ripple channel's dx would differ by > 1e-3. The other channels'
    dx, dγ and dβ are float64's within 3e-5."""
    n, h, w = 2, 16, 16
    m = n * h * w
    for seed in range(64):
        g = torch.Generator().manual_seed(seed)
        x0 = torch.randn(n, 4, h, w, generator=g)
        x0[:, 1] = 0.1
        x0[:, 2] = 1000 + 0.01 * torch.randn(n, h, w, generator=g)
        bn = _layer(4)
        _, stats = bn_kernel.forward_ref(x0, bn.weight, bn.bias, bn.running_mean.clone(),
                                         bn.running_var.clone(), EPS, 0.99, torch.float32)
        mean = x0.mean((0, 2, 3))
        written_raw = (x0 * x0).mean((0, 2, 3)) - mean * mean
        if stats[3, 2] == 1 and written_raw[2] < 0:
            break
    else:
        pytest.fail("no seed gave the ripple channel a negative f32 variance")
    dy = (torch.randn(n, 4, h, w, generator=g) * 1e-3 + 1e-4).double()
    ours = _grads(_plain, _layer(4), x0, dy)
    written = _grads(_written_out, _layer(4), x0, dy)
    ref = _grads(_written_out, _layer(4, dtype=torch.float64), x0.double(), dy)
    mul = stats[1].view(1, -1, 1, 1)
    gf = dy.float()
    first = mul * (gf - (gf.sum((0, 2, 3), dtype=torch.float64) / m).float().view(1, -1, 1, 1))
    torch.testing.assert_close(ours[1][:, 1:3], first[:, 1:3], rtol=1e-6, atol=0)
    assert _rel(ours[1][:, 1:3], written[1][:, 1:3]) <= 1e-5
    for got, want in zip(ours[1:], ref[1:]):
        assert _rel(got[:, 0::3] if got.dim() == 4 else got[0::3],
                    want[:, 0::3] if want.dim() == 4 else want[0::3]) <= 3e-5
    kept = stats.clone()
    kept[3] = 0
    dx_kept = bn_kernel.backward_ref(dy.float(), x0, _layer(4).weight.detach(), kept, True)[0]
    assert _rel(dx_kept[:, 2], written[1][:, 2]) > 1e-3


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_plain_version_running_statistics(out_dtype):
    """running_mean and running_var become 0.99·r + 0.01·(batch mean,
    biased variance), within 1e-6 of float64, as the written-out BN's."""
    x0, _ = _case((3, 5, 12, 10), 2.0, 1.5)
    bn, written = _layer(5), _layer(5)
    before = bn.running_mean.clone().double(), bn.running_var.clone().double()
    with torch.no_grad():
        _plain(bn, x0, out_dtype)
        towers._bn_f32(written, x0, True)
    xd = x0.double()
    want_mean = 0.99 * before[0] + 0.01 * xd.mean((0, 2, 3))
    want_var = 0.99 * before[1] + 0.01 * xd.var((0, 2, 3), unbiased=False)
    for got in (bn, written):
        torch.testing.assert_close(got.running_mean.double(), want_mean, rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(got.running_var.double(), want_var, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("shape,element_bytes,nhwc,want", [
    ((256, 64, 256, 199), 2, False, 32),  # audio block 1 at the train cell's batch, NCHW: 2048 CTAs
    ((256, 1, 256, 199), 4, False, 1592),  # the audio input BN (f32): 3,260,416 vectors, 2048 a slice
    ((256, 512, 32, 24), 2, False, 4),  # audio block 4, NCHW
    ((2, 10, 8, 8), 4, False, 1),  # too small to cut
    ((256, 64, 256, 199), 2, True, 2048),  # audio block 1, NHWC: slices of rows, every channel a CTA
    ((2, 3, 224, 224), 4, True, 36),  # the vision input BN of two frames, NHWC
])
def test_slices(shape, element_bytes, nhwc, want):
    """NCHW: a channel's elements are cut into at most ceil(2048 / C)
    slices; NHWC: the rows into at most 2048; each slice of at least 2048
    16-byte vectors, and at least one."""
    n, c, h, w = shape
    assert bn_kernel.slices(n, c, h * w, element_bytes, nhwc) == want


def test_layouts():
    """The kernel takes NCHW-dense x as NCHW, channels-last-dense x as NHWC,
    a one-channel x (both at once, as the audio input BN's permuted mel
    frames are) as NCHW, anything else after a copy; the plain version's y
    keeps x's layout, as the kernel's does."""
    nchw = torch.randn(2, 4, 5, 6)
    nhwc = torch.randn(2, 5, 6, 4).permute(0, 3, 1, 2)
    one = torch.randn(2, 5, 6, 1).permute(0, 3, 1, 2)
    odd = torch.randn(2, 4, 6, 5).transpose(2, 3)
    assert [bn_kernel.channels_last(t) for t in (nchw, nhwc, one)] == [False, True, False]
    assert not bn_kernel._dense(odd)
    for x in (nchw, nhwc, one, odd):
        bn = _layer(x.shape[1])
        y = _plain(bn, x, torch.bfloat16)
        want = x.stride() if bn_kernel._dense(x) else x.contiguous().stride()
        assert y.stride() == want
        torch.testing.assert_close(y.float(), _written_out(_layer(x.shape[1]), x).to(torch.bfloat16).float())


def test_bn_on_cpu_takes_tensor_ops(monkeypatch):
    """On the CPU ``towers._bn`` is the written-out BN inside its one
    ``tower.bn`` span: ``bn_train`` is not called and no launch is
    counted."""
    bn, x = _layer(3), torch.randn(2, 3, 8, 8)
    monkeypatch.setattr(towers, "bn_train", lambda *a, **k: pytest.fail("bn_train called on the CPU"))
    bn_kernel.LAUNCHES.clear()
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        y = towers._bn(bn, x, torch.float32, train=True)
    spans = [s for s in trace.spans() if s.name == "tower.bn"]
    trace.clear()
    assert len(spans) == 1
    torch.testing.assert_close(y, _written_out(_layer(3), x))
    assert not bn_kernel.LAUNCHES


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_SYNC_JOBS: dict = {}


def _sync_job(tmp_path_factory, backend: str, device: str) -> list[dict]:
    """Both ranks' results of tests/torch_port_bn_sync_worker.py (one job a
    backend and device for the module)."""
    key = (backend, device)
    if key not in _SYNC_JOBS:
        work = tmp_path_factory.mktemp(f"bn_sync_{backend}")
        port = _free_port()
        outs = [str(work / f"rank{r}.json") for r in range(2)]
        procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_port_bn_sync_worker.py"), str(r),
                                   str(port), backend, device, outs[r]],
                                  env=dict(os.environ, OMP_NUM_THREADS="1"), stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for r in range(2)]
        try:
            logs = [p.communicate(timeout=300)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
        for r, (p, log) in enumerate(zip(procs, logs)):
            assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-4000:]}"
        results = []
        for out in outs:
            with open(out) as f:
                results.append(json.load(f))
        _SYNC_JOBS[key] = results
    return _SYNC_JOBS[key]


def _check_sync(results: list[dict], case: str, on_card: bool) -> None:
    """Each rank's y, dx, dγ, dβ and running statistics within
    SYNC_LIMITS of the float64 written-out sync BN; the rank's own
    statistics alone would put y at least 20x further off than the bound
    (the check sees a missing all-reduce); on the card one forward (and
    one without the group) and one backward on the kernel, else none."""
    _, _, in_dtype, out_dtype, grad, _ = SYNC_CASES[case]
    kind = bn_kernel._KINDS[out_dtype]
    for r, res in enumerate(results):
        got = res[case]
        print(f"rank {r} {case}: {got}")
        for name, err in got["errs"].items():
            limit = SYNC_LIMITS[name]
            if isinstance(limit, dict):
                limit = limit[out_dtype if name == "y" else in_dtype]
            assert err <= limit, (r, case, name, err, limit)
        assert set(got["errs"]) >= {"y", "dscale", "dbias", "running_mean", "running_var"}
        assert ("dx" in got["errs"]) == grad and got["grad_is_none"] == (not grad)
        assert got["local_y_err"] >= 20 * SYNC_LIMITS["y"][out_dtype], (r, case, got["local_y_err"])
        assert got["launches"] == ({kind: 2, f"{kind}_backward": 1} if on_card else {})


@pytest.mark.parametrize("case", list(SYNC_CASES))
def test_plain_version_sync_bn_two_ranks(case, tmp_path_factory):
    """Under sync BN on two gloo ranks of the CPU, the plain version with
    its sums all-reduced equals the written-out sync BN (float64) on each
    rank's rows: ``_check_sync``."""
    _check_sync(_sync_job(tmp_path_factory, "gloo", "cpu"), case, on_card=False)


# ---------------------------------------------------------------- on the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _ulp_close(what, got, want, rtol, atol):
    """|got − want| ≤ rtol·|want| + atol everywhere; prints the worst."""
    got, want = got.detach().double(), want.detach().double()
    err = (got - want).abs()
    bound = rtol * want.abs() + atol
    worst = float((err / bound).max())
    print(f"{what}: max |diff| {float(err.max()):.3e}, worst diff/bound {worst:.3f}, "
          f"{int((err > 0).sum())} of {err.numel()} differ")
    assert worst <= 1.0, what


def _sum_bound(terms):
    """The per-channel bound on two f32 summation orders of `terms` (N, C,
    H, W): 2e-5 of Σ|t|. Either order's rounding error is under ~(a thread's
    ~50 rounds + 32 elements + an 8-level tree)·2^-24 ≈ 6e-6 of Σ|t|."""
    return 2e-5 * terms.double().abs().sum((0, 2, 3))


CARD_CASES = {
    # name: (shape, in dtype, out dtype, x takes a gradient, layout in memory)
    "audio_block1": ((8, 64, 256, 199), torch.bfloat16, torch.bfloat16, True, "nhwc"),
    "audio_block1_nchw": ((8, 64, 256, 199), torch.bfloat16, torch.bfloat16, True, "nchw"),
    "audio_block4": ((8, 512, 32, 24), torch.bfloat16, torch.bfloat16, True, "nhwc"),
    "audio_input": ((8, 1, 256, 199), torch.float32, torch.bfloat16, False, "nhwc"),  # the permuted mel frames
    "vision_input": ((8, 3, 224, 224), torch.float32, torch.bfloat16, False, "nhwc"),  # one element a step
    "tiny_f32": ((8, 10, 220, 220), torch.float32, torch.float32, True, "nchw"),
    "odd_planes": ((3, 10, 73, 73), torch.float32, torch.float32, True, "nchw"),  # one element a step
    "odd_planes_bf16": ((4, 6, 7, 9), torch.bfloat16, torch.bfloat16, True, "nchw"),
    "odd_rows_bf16": ((4, 6, 7, 9), torch.bfloat16, torch.bfloat16, True, "nhwc"),  # C = 6: one element a step
    "f32_in_f32_out_nhwc": ((4, 64, 30, 20), torch.float32, torch.float32, True, "nhwc"),
    "bf16_in_f32_out": ((4, 16, 30, 20), torch.bfloat16, torch.float32, True, "nchw"),
}


def _card_inputs(case, device, seed=0):
    shape, in_dtype, _, grad, layout = CARD_CASES[case]
    g = torch.Generator(device=device).manual_seed(seed)
    n, c, h, w = shape
    if layout == "nhwc":
        x = torch.randn(n, h, w, c, generator=g, device=device).permute(0, 3, 1, 2)
    else:
        x = torch.randn(*shape, generator=g, device=device)
    x = (x * 1.7 + 0.4).to(in_dtype)
    dy = (torch.randn(n, h, w, c, generator=g, device=device).permute(0, 3, 1, 2) * 1e-3 + 1e-4)
    return x, dy.to(memory_format=torch.channels_last if layout == "nhwc" else torch.contiguous_format)


def _run(case, device, kernel, seed=0):
    """(y, dx, dγ, dβ, running_mean, running_var, stats) of one forward and
    backward: the kernel, or the plain version on the same card tensors."""
    _, _, out_dtype, grad, _ = CARD_CASES[case]
    x, dy = _card_inputs(case, device, seed)
    bn = _layer(x.shape[1], device=device)
    x = x.detach().requires_grad_(grad)
    if kernel:
        y = _plain(bn, x, out_dtype)
        stats = None
    else:
        x = x.detach()
        y, stats = bn_kernel.forward_ref(x, bn.weight, bn.bias, bn.running_mean, bn.running_var, EPS, 0.99,
                                         out_dtype)
    dy = dy.to(out_dtype)
    if kernel:
        y.backward(dy)
        dx, dw, db = x.grad, bn.weight.grad, bn.bias.grad
    else:
        dx, dw, db = bn_kernel.backward_ref(dy, x, bn.weight.detach(), stats, grad)
    torch.cuda.synchronize()
    return y.detach(), dx, dw, db, bn.running_mean, bn.running_var, stats, x.detach(), dy


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_kernel_vs_plain_on_card(case):
    """The kernel against the plain version on the same card tensors.
    Tolerances: the two differ in the order of their f32 sums (each within
    ~6e-6 of Σ|t|, see _sum_bound) and, through them, by an ulp or so of
    mean and mul; then by the final rounding of y and dx to their dtype.
    - running statistics and dβ, dγ: within _sum_bound of their terms
      (running: times 0.01, plus an f32 ulp of the running value);
    - y: one ulp of its dtype (2^-7 of |y| in bf16, 2^-22 in f32) plus 1e-5 (y is O(1):
      mean's and mul's ulps times |x − mean|·mul);
    - dx: one ulp of its dtype plus 1e-4 of max |dx| (the coefficients'
      sum-order differences times mul or |x − mean|)."""
    device = _card()
    _, _, out_dtype, grad, _ = CARD_CASES[case]
    bn_kernel.LAUNCHES.clear()
    y, dx, dw, db, rm, rv, _, x, dy = _run(case, device, kernel=True)
    assert bn_kernel.LAUNCHES == {bn_kernel._KINDS[out_dtype]: 1, f"{bn_kernel._KINDS[out_dtype]}_backward": 1}
    assert y.stride() == x.stride() and (dx is None or dx.stride() == x.stride())
    ry, rdx, rdw, rdb, rrm, rrv, stats, _, _ = _run(case, device, kernel=False)
    mean, mul, rstd, _ = stats
    xc = x.float() - mean.view(1, -1, 1, 1)
    g = dy.float()
    ulp_y = 2.0 ** -7 if out_dtype == torch.bfloat16 else 2.0 ** -22
    ulp_x = 2.0 ** -7 if x.dtype == torch.bfloat16 else 2.0 ** -22
    _ulp_close(f"{case} running_mean", rm, rrm, 2.0 ** -23, 0.01 * _sum_bound(x.float()) / (x.numel() / x.shape[1]))
    _ulp_close(f"{case} running_var", rv, rrv, 2.0 ** -23,
               0.01 * 3 * _sum_bound(x.float() ** 2) / (x.numel() / x.shape[1]))
    _ulp_close(f"{case} y", y, ry, ulp_y, 1e-5)
    _ulp_close(f"{case} dbias", db, rdb, 0.0, _sum_bound(g))
    _ulp_close(f"{case} dscale", dw, rdw, 2.0 ** -22, rstd.double() * _sum_bound(g * xc))
    if grad:
        _ulp_close(f"{case} dx", dx, rdx, ulp_x, 1e-4 * float(rdx.double().abs().max()))
    else:
        assert dx is None


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["audio_block1", "audio_block1_nchw", "audio_input", "odd_planes"])
def test_kernel_repeats_bit_for_bit(case):
    """Two runs from the same inputs give the same bits: y, dx, dγ, dβ and
    the running statistics (no float atomics; sums in a fixed order)."""
    device = _card()
    a = _run(case, device, kernel=True)[:6]
    b = _run(case, device, kernel=True)[:6]
    for t, u in zip(a, b):
        assert (t is None and u is None) or torch.equal(t, u)


@pytest.mark.cuda
def test_melspec2_bf16_step_runs_every_bn_on_the_kernel():
    """A cnn_L3_melspec2 bf16 train step on the card: 18 forward and 18
    backward launches of the kernel, 36 traced ``tower.bn`` spans (18
    forward, 18 backward), no torch batch_norm op (native, cuDNN's or the
    fused one) in the step's trace, and a finite loss."""
    from l3embedding_torch.models.registry import build_model
    from l3embedding_torch.training.state import create_train_state
    from l3embedding_torch.training.steps import make_train_step

    device = _card()
    rng = np.random.RandomState(3)
    b = 2
    lab = rng.randint(0, 2, b)
    batch = {"video": torch.from_numpy(rng.randint(0, 256, (b, 224, 224, 3)).astype(np.uint8)).to(device),
             "audio": torch.from_numpy((rng.randn(b, 1, 48000) * 3000).astype(np.int16)).to(device),
             "label": torch.from_numpy(np.stack([lab, 1 - lab], 1).astype(np.float32)).to(device)}
    state = create_train_state(build_model("cnn_L3_melspec2"), torch.Generator().manual_seed(1), 1e-4,
                               compute_dtype=torch.bfloat16, device=device)
    step = make_train_step()
    step(state, batch)  # builds the kernels
    torch.cuda.synchronize()
    bn_kernel.LAUNCHES.clear()
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, metrics = step(state, batch)
        loss = float(metrics["loss"])
    spans = trace.spans()
    trace.clear()
    assert bn_kernel.LAUNCHES == {"bf16": 18, "bf16_backward": 18}
    assert len([s for s in spans if s.name == "tower.bn"]) == 36
    names = {e.name for e in prof.events()}
    assert not {n for n in names if "batch_norm" in n}, names
    assert np.isfinite(loss)


@pytest.mark.cuda
@pytest.mark.parametrize("backend,device", [("gloo", "cuda"), ("nccl", "cuda:rank")],
                         ids=["gloo_one_card", "nccl_two_cards"])
@pytest.mark.parametrize("case", list(SYNC_CASES))
def test_kernel_sync_bn_two_ranks(case, backend, device, tmp_path_factory):
    """Under sync BN on two ranks (gloo, both on one card; NCCL, a card
    each), the kernel with its sums all-reduced equals the written-out sync
    BN (float64) on each rank's rows: ``_check_sync``."""
    _card()
    if backend == "nccl" and torch.cuda.device_count() < 2:
        pytest.skip("NCCL needs two cards")
    _check_sync(_sync_job(tmp_path_factory, backend, device), case, on_card=True)
