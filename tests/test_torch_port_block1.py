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
