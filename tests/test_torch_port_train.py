"""The port's AVC train path against the JAX package on the CPU: BatchNorm
in train mode per tower, one train step (f32, accumulating, bf16), the
eval step, the L2 penalty and the batch conversion.

The flax variables of each model type are drawn once from a seeded numpy
generator (He-scaled kernels, nonzero biases, BN statistics away from the
identity) and carried into the port with ``compat.from_jax``; both packages
take one step on the same numpy batch (uint8 video, int16 audio) with a
fresh Adam. The port's gradients are its ``.grad`` after the step; JAX's
are read back from its new Adam state (after one update ``mu`` is exactly
``0.1 · grad``).

Gates and what sets them:
  * f32: loss, acc and reg_loss within 1e-5 relative; every gradient leaf,
    new parameter and new batch statistic at cosine >= 0.99999, and its
    norm within 2 % (the cosine alone does not see a scale; the audio input
    BN's one-element scale and bias gradients differ by up to 1.1 %).
  * A conv bias that feeds a train-mode BatchNorm has a gradient that is
    zero but for rounding (the BN takes the batch mean out): its value is
    noise in both packages (``bn_fed_bias_ratio`` in the printed report),
    and Adam's first step moves it by up to ``lr`` in a direction
    set by that noise. Such leaves are held to max |grad| <= 1e-3 · max
    |grad| of the BN bias they feed, and to a step of at most ``lr``.
  * cnn_L3_melspec2 with each package's own f32 mel front end: the two
    front ends each lie within 1e-4 dB of a float64 one, and that
    difference alone moves five audio BN-bias gradients to cosine
    0.999978-0.999988 (measured: with JAX's front end fed into the port,
    every leaf is at >= 0.9999975). The 0.99999 gate is held with the
    front end shared and against the same step in float64; against JAX
    with the port's own front end the gradient gate is 0.99997.
  * bf16: one bf16 step's gradients lie far from the f32 step's in both
    packages at this depth, leaf by leaf (JAX's own bf16 gradients at
    cosine 0.54-1.0 per leaf against its f32 ones, the port's 0.82-1.0,
    on other leaves; the test prints both), so a per-leaf gate against
    JAX's bf16 step cannot hold. The port is held to the loss within 1e-2
    relative, the same accuracy, every BN batch statistic within 2e-2 of
    JAX's bf16 one (measured 5.5e-3), and a mean gradient distance from
    JAX's f32 step at most 1.5x JAX's bf16 one (measured 0.73x)
    (test_train_step_melspec2_bf16). Planted faults
    (test_bf16_gates_catch_planted_faults): BN statistics reduced in bf16
    leave the gradients at 0.92x but put the batch statistics 0.11 off;
    the BN's batch mean detached from the gradient leaves loss and
    statistics as they are and lands at 2.01x. Within bf16's noise for
    these two gates: the BN variance detached (1.14x), the unbiased
    variance (0.99x; its loss lands 1.1e-2 off), the mel output rounded
    to bf16 (0.72x).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from l3embedding_tpu.models import build_model as jax_build_model
from l3embedding_tpu.ops import frontend as jax_frontend
from l3embedding_tpu.training.state import AVCTrainState, make_optimizer
from l3embedding_tpu.training.steps import l2_penalty as jax_l2_penalty
from l3embedding_tpu.training.steps import make_eval_step as jax_make_eval_step
from l3embedding_tpu.training.steps import make_train_step as jax_make_train_step
from l3embedding_tpu.training.steps import preprocess_batch as jax_preprocess_batch
from l3embedding_torch.compat.from_jax import (
    avc_from_jax_variables,
    avc_leaves,
    bn_fed_biases,
    from_jax_variables,
    vision_from_jax_variables,
)
from l3embedding_torch.compat.to_jax import adam_to_jax, avc_to_jax_variables
from l3embedding_torch.models import avc, towers
from l3embedding_torch.models.registry import build_model
from l3embedding_torch.training.state import create_train_state
from l3embedding_torch.training.steps import (
    _ce_acc,
    _inputs,
    l2_penalty,
    make_eval_step,
    make_train_step,
    preprocess_batch,
)
from torch_port_threads import two_torch_threads  # noqa: F401

LR = 1e-4


def _leaf(rng, path, shape):
    name = getattr(path[-1], "key", "")
    if name == "kernel":  # conv HWIO or dense (in, out): He-normal scale
        return rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[:-1]))
    if name == "scale":
        return 1.0 + 0.1 * rng.randn(*shape)
    if name == "var":
        return 1.0 + 0.3 * np.abs(rng.randn(*shape))
    return 0.05 * rng.randn(*shape)  # biases and means


_VARIABLES = {}


def variables(model_type):
    """Numpy flax variables {"params", "batch_stats"} of a model type."""
    if model_type not in _VARIABLES:
        model = jax_build_model(model_type).module()
        shapes = jax.eval_shape(
            lambda: model.init(
                jax.random.PRNGKey(0),
                np.zeros((1, 224, 224, 3), np.float32),
                np.zeros((1, 1, 48000), np.float32),
                train=False,
            )
        )
        rng = np.random.RandomState(sum(map(ord, model_type)))
        _VARIABLES[model_type] = {
            k: jax.tree_util.tree_map_with_path(
                lambda p, s: _leaf(rng, p, s.shape).astype(np.float32), shapes[k]
            )
            for k in ("params", "batch_stats")
        }
    return _VARIABLES[model_type]


def make_batch(batch, seed=7):
    rng = np.random.RandomState(seed)
    lab = rng.randint(0, 2, batch)
    return {
        "video": rng.randint(0, 256, (batch, 224, 224, 3)).astype(np.uint8),
        "audio": (rng.randn(batch, 1, 48000) * 3000).astype(np.int16),
        "label": np.stack([lab, 1 - lab], axis=1).astype(np.float32),
    }


def flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, np.float64)


def cosine(a, b):
    a, b = np.ravel(a), np.ravel(b)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-300))


def bn_fed_paths(model_type):
    """``bn_fed_biases`` by flax path: {conv bias: the BN bias it feeds}."""
    paths = {name: path for name, _, path, _ in avc_leaves(model_type)}
    return {paths[c]: paths[b] for c, b in bn_fed_biases(model_type).items()}


def jax_step(model_type, batch, dtype=jnp.float32, accum_steps=1):
    """→ (new numpy state trees, metrics, gradients by flax path) of JAX's
    step."""
    v = variables(model_type)
    model = jax_build_model(model_type).module(compute_dtype=dtype)
    tx = make_optimizer(LR)
    state = AVCTrainState(
        step=jnp.zeros((), jnp.int32), params=v["params"], batch_stats=v["batch_stats"],
        opt_state=tx.init(v["params"]), tx=tx,
    )
    new, metrics = jax_make_train_step(model, donate=False, accum_steps=accum_steps)(state, batch)
    host = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    trees = {"params": host(new.params), "batch_stats": host(new.batch_stats),
             "mu": host(new.opt_state[0].mu)}
    grads = {path: mu / 0.1 for path, mu in flat(trees["mu"])}
    return trees, {k: float(x) for k, x in metrics.items()}, grads


def port_state(model_type, dtype=torch.float32, db_batch_global=False):
    state = create_train_state(
        build_model(model_type), torch.Generator().manual_seed(0), LR, dtype, "cpu", db_batch_global
    )
    state.model.load_state_dict(avc_from_jax_variables(variables(model_type), model_type))
    return state


def port_step(model_type, batch, dtype=torch.float32, accum_steps=1, bn_mode="sync", db_batch_global=False):
    """→ (new flax-layout trees, metrics, gradients by flax path) of the
    port's step."""
    state = port_state(model_type, dtype, db_batch_global)
    state, metrics = make_train_step(accum_steps=accum_steps, bn_mode=bn_mode)(
        state, {k: torch.from_numpy(x) for k, x in batch.items()}
    )
    assert state.step == 1
    trees = avc_to_jax_variables(state.model, model_type)
    trees["mu"] = adam_to_jax(state.model, model_type, state.optimizer)["0"]["mu"]
    params = dict(state.model.named_parameters())
    grads = {}
    for name, coll, path, layout in avc_leaves(model_type):
        if coll == "params":
            g = params[name].grad.detach().double().numpy()
            grads[path] = g.transpose(2, 3, 1, 0) if layout == "conv" else g.T if layout == "dense" else g
    return trees, {k: float(x) for k, x in metrics.items()}, grads


def check_metrics(ours, theirs, rel):
    print(f"metrics: port {ours}, JAX {theirs}")
    for k in ("loss", "acc", "reg_loss"):
        assert abs(ours[k] - theirs[k]) <= rel * max(abs(theirs[k]), 1e-12), (k, ours[k], theirs[k])


def check_step(model_type, ours, theirs, grad_gate=0.99999, old_params=None, lr=LR):
    """Every gradient leaf, new parameter, new batch statistic and Adam
    first moment of two steps from the same state (module docstring's
    gates; the state's parameters ``variables(model_type)``'s unless
    old_params is given, its learning rate lr); → the worst (cosine, max
    |Δ|, leaf) per kind, for the report."""
    (o_trees, _, o_grads), (t_trees, _, t_grads) = ours, theirs
    noise = bn_fed_paths(model_type)
    worst = {}
    old = dict(flat(old_params if old_params is not None else variables(model_type)["params"]))
    for kind, o, t, gate in (
        ("grad", o_grads, t_grads, grad_gate),
        ("mu", dict(flat(o_trees["mu"])), dict(flat(t_trees["mu"])), grad_gate),
        ("param", dict(flat(o_trees["params"])), dict(flat(t_trees["params"])), 0.99999),
        ("batch_stats", dict(flat(o_trees["batch_stats"])), dict(flat(t_trees["batch_stats"])), 0.99999),
    ):
        assert o.keys() == t.keys()
        rows = []
        for path in t:
            a, b = np.asarray(o[path], np.float64), np.asarray(t[path], np.float64)
            assert a.shape == b.shape, path
            if path in noise and kind in ("grad", "mu"):
                for grads in (o, t):
                    ratio = np.abs(grads[path]).max() / np.abs(grads[noise[path]]).max()
                    worst["bn_fed_bias_ratio"] = max(worst.get("bn_fed_bias_ratio", 0.0), ratio)
                    assert ratio <= 1e-3, (kind, path)
                continue
            if path in noise and kind == "param":
                assert np.abs(a - old[path]).max() <= lr * (1 + 1e-3), path
                assert np.abs(b - old[path]).max() <= lr * (1 + 1e-3), path
                continue
            c = cosine(a, b)
            rows.append((c, float(np.abs(a - b).max()), "/".join(path)))
            assert c >= gate, (kind, "/".join(path), c, gate)
            # The cosine does not see a scale (nor anything in a one-element
            # leaf): hold the norms within 2 %. The audio input BN's
            # one-channel scale and bias gradients, sums that cancel over
            # every input position, differ by up to 1.1 % (printed below).
            dev = abs(np.linalg.norm(a) / np.linalg.norm(b) - 1)
            worst["norm_dev"] = max(worst.get("norm_dev", 0.0), dev)
            assert dev <= 2e-2, (kind, path)
        worst[kind] = min(rows)
    return worst


# ---------------------------------------------------------------- BN train mode

TOWERS = [
    ("tiny_L3", "audio"), ("tiny_L3", "vision"),
    ("cnn_L3_melspec2", "audio"), ("cnn_L3_melspec2", "vision"),
    ("cnn_L3_orig", "audio"), ("cnn_L3_orig", "vision"),
    ("cnn_L3_kapredbinputbn", "audio"),
]


def _tower_input(tower, batch=2):
    rng = np.random.RandomState(11)
    if tower == "audio":
        return (rng.randn(batch, 1, 48000) * 0.2).astype(np.float32)
    return rng.uniform(-1, 1, (batch, 224, 224, 3)).astype(np.float32)


@pytest.mark.parametrize("model_type,tower", TOWERS)
def test_bn_train_mode_tower(model_type, tower):
    """A tower in train mode: output and updated running statistics equal
    flax's apply(train=True, mutable=["batch_stats"])."""
    v = variables(model_type)
    name = f"{tower}_model"
    jax_tower = getattr(jax_build_model(model_type).module(), name)
    x = _tower_input(tower)
    sub = {k: v[k][name] for k in ("params", "batch_stats")}
    y_jax, upd = jax.jit(
        lambda s, x: jax_tower.apply(s, x, train=True, mutable=["batch_stats"])
    )(sub, x)
    spec = build_model(model_type)
    if tower == "audio":
        ours = spec.audio_tower()
        ours.load_state_dict(from_jax_variables(v, model_type))
    else:
        ours = spec.vision_tower()
        ours.load_state_dict(vision_from_jax_variables(v, model_type))
    y = ours(torch.from_numpy(x), train=True).detach().numpy()
    y_jax = np.asarray(y_jax)
    assert y.shape == y_jax.shape
    for a, b in zip(y, y_jax):
        assert cosine(a, b) >= 0.99999
    assert np.abs(y - y_jax).max() <= 1e-3 * np.abs(y_jax).max()
    # The running statistics: flax's biased update, read back as flax's tree.
    new_sd = {f"{name}.{k}": t for k, t in ours.state_dict().items()}
    new_bs = {}
    for tname, coll, path, _ in avc_leaves(model_type):
        if coll == "batch_stats" and tname.startswith(name + "."):
            new_bs[path[1:]] = new_sd[tname].numpy()
    want = dict(flat(jax.tree.map(np.asarray, upd["batch_stats"])))
    assert new_bs.keys() == want.keys()
    for path, b in want.items():
        a = new_bs[path]
        assert cosine(a, b) >= 0.99999, path
        assert np.abs(a - b).max() <= 1e-5 * max(np.abs(b).max(), 1.0), path


def test_bn_train_mode_updates_biased_variance():
    """One BatchNorm in train mode: running_var moves by 0.01·(the biased
    batch variance), and the output is normalised with it."""
    bn = torch.nn.BatchNorm2d(3, eps=1e-3)
    bn.running_var.fill_(2.0)
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 3, 4, 5).astype(np.float32) * 3 + 1)
    y = towers._bn(bn, x, torch.float32, train=True)
    xd = x.double()
    var_b = xd.var(dim=(0, 2, 3), unbiased=False)
    mean = xd.mean(dim=(0, 2, 3))
    np.testing.assert_allclose(bn.running_var.numpy(), 0.99 * 2.0 + 0.01 * var_b.numpy(), rtol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(), 0.01 * mean.numpy(), rtol=1e-5, atol=1e-7)
    want = (xd - mean.view(1, -1, 1, 1)) / torch.sqrt(var_b.view(1, -1, 1, 1) + 1e-3)
    np.testing.assert_allclose(y.detach().numpy(), want.numpy(), rtol=1e-4, atol=1e-5)


def test_eval_forward_unchanged_by_train_flag():
    """train=False (the default) is the eval path: running statistics used,
    none updated."""
    model_type = "tiny_L3"
    model = port_state(model_type).model
    before = {k: t.clone() for k, t in model.state_dict().items()}
    b = make_batch(2)
    video, audio = preprocess_batch(torch.from_numpy(b["video"]), torch.from_numpy(b["audio"]))
    with torch.no_grad():
        a1 = model(video, audio)
        a2 = model(video, audio, train=False)
    assert torch.equal(a1, a2)
    for k, t in model.state_dict().items():
        assert torch.equal(t, before[k]), k


@pytest.mark.parametrize("shape,scale,offset", [
    ((2, 3, 224, 224), 0.57, 0.0),  # the vision input BN
    ((2, 1, 256, 199), 15.0, -40.0),  # the audio input BN on dB mels
    ((2, 64, 224, 224), 1.0, 0.5),  # a block-1 BN
])
def test_bn_train_grads_vs_float64(shape, scale, offset):
    """One train-mode BN layer in f32 (flax's arithmetic, written out): dx,
    dscale and dbias within 3e-5 relative of the float64 ones. Printed beside
    them, torch's fused batch_norm: the same order (the written-out dscale is
    the worse, 9e-6 against 4e-6, on the one-channel dB input, mean −40 and
    std 15, where E[x²] − E[x]² cancels; the better elsewhere)."""
    torch.manual_seed(0)
    c = shape[1]
    x0 = torch.randn(*shape) * scale + offset
    w0, b0 = 1 + 0.1 * torch.randn(c), 0.05 * torch.randn(c)
    dy = (torch.randn(*shape) * 1e-3 + 1e-4).double()

    def grads(dtype, fused):
        x = x0.to(dtype).clone().requires_grad_()
        bn = torch.nn.BatchNorm2d(c, eps=1e-3).to(dtype)
        with torch.no_grad():
            bn.weight.copy_(w0)
            bn.bias.copy_(b0)
        if fused:
            y = torch.nn.functional.batch_norm(x, None, None, bn.weight, bn.bias, training=True, eps=1e-3)
        else:
            y = towers._bn(bn, x, torch.float32, train=True)
        (y.double() * dy).sum().backward()
        return [t.grad.double() for t in (x, bn.weight, bn.bias)]

    ref = grads(torch.float64, fused=True)
    rel = lambda g: [float((a - r).norm() / r.norm()) for a, r in zip(g, ref)]  # noqa: E731
    ours, theirs = rel(grads(torch.float32, fused=False)), rel(grads(torch.float32, fused=True))
    print(f"BN {shape}: dx, dscale, dbias relative error vs float64: written out "
          f"{['%.2e' % e for e in ours]}, torch's fused {['%.2e' % e for e in theirs]}")
    assert max(ours) <= 3e-5


def test_mel_frontends_vs_float64():
    """The f32 and bf16 mel front ends of both packages against a float64
    one (the port's framing, bases and filterbank in float64), in dB: every
    f32 value within 1e-3 dB, every bf16 value within 1 dB."""
    from l3embedding_torch.ops import dsp_ref
    from l3embedding_torch.ops import frontend as tfe
    from l3embedding_torch.ops.mel_kernel import melspectrogram_fused_ref

    b = make_batch(2)
    audio = b["audio"][:, 0].astype(np.float32) / 32768
    cfg, jcfg = tfe.MelConfig(n_mels=256), jax_frontend.MelConfig(n_mels=256)
    x = torch.from_numpy(audio)
    frames = tfe.frame_signal(x.double(), cfg.n_dft, cfg.hop, cfg.padding)
    re, im = (torch.from_numpy(a) for a in dsp_ref.stft_basis(cfg.n_dft))
    power = (frames @ re) ** 2 + (frames @ im) ** 2
    m = power @ torch.from_numpy(np.asarray(tfe.mel_matrix(cfg), np.float64))
    truth = tfe.to_nhwc_db(torch.sqrt(torch.clamp(m, min=0.0)), cfg).numpy()
    got = {
        "port f32": melspectrogram_fused_ref(x, cfg, False).numpy(),
        "JAX f32": np.asarray(jax_frontend.melspectrogram(
            jnp.asarray(audio), jcfg, precision=jax.lax.Precision.HIGHEST)),
        "port bf16": melspectrogram_fused_ref(x, cfg, True).numpy(),
        "JAX bf16": np.asarray(jax_frontend.melspectrogram_bf16(jnp.asarray(audio), jcfg), np.float32),
    }
    for name, y in got.items():
        d = np.abs(y.astype(np.float64) - truth)
        print(f"{name} mel vs float64: max {d.max():.3e} dB, mean {d.mean():.3e} dB")
        assert d.max() <= (1.0 if "bf16" in name else 1e-3), name


# ---------------------------------------------------------------- train step

def test_train_step_tiny_f32():
    batch = make_batch(4)
    ours, theirs = port_step("tiny_L3", batch), jax_step("tiny_L3", batch)
    check_metrics(ours[1], theirs[1], 1e-5)
    worst = check_step("tiny_L3", ours, theirs)
    print("tiny_L3 f32 step, worst (cosine, max |d|, leaf):", worst)


def _jax_mel(x, cfg, fast):
    """JAX's f32 HIGHEST-precision mel front end, in place of the port's."""
    jcfg = jax_frontend.MelConfig(n_mels=cfg.n_mels, db_per_sample=cfg.db_per_sample)
    y = jax_frontend.melspectrogram(jnp.asarray(x.numpy()), jcfg, precision=jax.lax.Precision.HIGHEST)
    return torch.from_numpy(np.array(y))


@pytest.fixture(scope="module")
def melspec2_f32():
    batch = make_batch(2)
    return batch, jax_step("cnn_L3_melspec2", batch)


def test_train_step_melspec2_f32_shared_frontend(melspec2_f32, monkeypatch):
    """cnn_L3_melspec2 at batch 2, f32, with the port's tower fed JAX's front
    end: every leaf at the 0.99999 gate."""
    batch, theirs = melspec2_f32
    monkeypatch.setattr(towers, "melspectrogram_fused", _jax_mel)
    ours = port_step("cnn_L3_melspec2", batch)
    check_metrics(ours[1], theirs[1], 1e-5)
    worst = check_step("cnn_L3_melspec2", ours, theirs)
    print("melspec2 f32 step (JAX front end), worst:", worst)


@pytest.fixture(scope="module")
def port_melspec2_f32(melspec2_f32):
    """The port's own f32 step on the f32 fixture's batch (its front end the
    kernel's plain version on the CPU)."""
    batch, _ = melspec2_f32
    return port_step("cnn_L3_melspec2", batch)


def test_train_step_melspec2_f32(melspec2_f32, port_melspec2_f32):
    """The whole port step with its own front end (the kernel's plain
    version on the CPU): gradients at 0.99997 against JAX's (measured
    0.9999756 worst on the module's two threads; 0.9999782 on eight)."""
    batch, theirs = melspec2_f32
    ours = port_melspec2_f32
    check_metrics(ours[1], theirs[1], 1e-5)
    worst = check_step("cnn_L3_melspec2", ours, theirs, grad_gate=0.99997)
    print("melspec2 f32 step, worst:", worst)


def _bn_float64(bn, x, dtype, train=False):
    """Train-mode BatchNorm in float64 (running statistics not touched)."""
    return F.batch_norm(x.double(), None, None, bn.weight.double(), bn.bias.double(),
                        training=True, eps=bn.eps)


def _bn_fused(bn, x, dtype, train=False):
    """Train-mode BN by torch's fused kernel, running statistics from one
    var_mean: the form the port does not take (printed for the record)."""
    x = x.float()
    with torch.no_grad():
        var, mean = torch.var_mean(x, (0, 2, 3), unbiased=False)
        bn.running_mean.mul_(0.99).add_(mean, alpha=0.01)
        bn.running_var.mul_(0.99).add_(var, alpha=0.01)
    return F.batch_norm(x, None, None, bn.weight, bn.bias, training=True, eps=bn.eps).to(dtype)


def test_train_step_melspec2_f32_vs_float64(melspec2_f32, port_melspec2_f32, monkeypatch):
    """The port's own f32 step against the same step with every conv,
    BatchNorm and dense layer in float64 (from the same f32 front-end
    output; the logits rounded to f32): every gradient leaf at cosine >=
    0.99999 (measured 0.9999918 worst on two threads, 0.999992 on eight,
    the vision input BN's bias). Printed
    beside it: the step with torch's fused BN in place of the written-out
    one, against float64 and against JAX."""
    batch, (_, _, jax_grads) = melspec2_f32
    ours = port_melspec2_f32[2]
    with monkeypatch.context() as m:
        m.setattr(towers, "_bn", _bn_fused)
        fused = port_step("cnn_L3_melspec2", batch)[2]
    monkeypatch.setattr(towers, "_conv", lambda conv, x, dtype: F.conv2d(
        x.double(), conv.weight.double(), conv.bias.double(), padding=conv.padding))
    monkeypatch.setattr(towers, "_bn", _bn_float64)
    monkeypatch.setattr(towers, "nhwc_flatten", lambda x: x.permute(0, 2, 3, 1).flatten(1))
    monkeypatch.setattr(avc, "_dense", lambda layer, x, dtype: F.linear(
        x.double(), layer.weight.double(), layer.bias.double()))
    truth = port_step("cnn_L3_melspec2", batch)[2]
    noise = bn_fed_paths("cnn_L3_melspec2")
    rows = sorted((cosine(ours[p], t), "/".join(p)) for p, t in truth.items() if p not in noise)
    print("melspec2 f32 step vs float64, worst:", rows[:3])
    for ref, what in ((truth, "float64"), (jax_grads, "JAX")):
        worst = min((cosine(fused[p], r), "/".join(p)) for p, r in ref.items() if p not in noise)
        print(f"the same step with torch's fused BN vs {what}, worst: {worst}")
    assert rows[0][0] >= 0.99999, rows[0]


@pytest.mark.parametrize("model_type", [
    "tiny_L3", "cnn_L3_orig", "cnn_L3_kapredbinputbn", "cnn_L3_melspec1", "cnn_L3_melspec2"])
def test_bn_fed_biases(model_type):
    """Every conv bias but vision block 1's second (ReLU before its BN)
    maps to the bias of the BN its conv feeds, in the same tower."""
    model = build_model(model_type).module()
    params = dict(model.named_parameters())
    conv_biases = {n for n, m in model.named_modules() if isinstance(m, torch.nn.Conv2d)}
    got = bn_fed_biases(model_type)
    assert set(got) == {f"{n}.bias" for n in conv_biases} - {"vision_model.blocks.1.conv.bias"}
    for conv, bn in got.items():
        assert bn in params and conv.split(".")[0] == bn.split(".")[0]
        assert params[conv].shape == params[bn].shape
        module = model.get_submodule(bn.rsplit(".", 1)[0])
        assert isinstance(module, torch.nn.BatchNorm2d), bn


def float64_step_grads(model_type, batch):
    """The port's step on a float64 copy of the same state (BN, convs and
    loss in float64 from the inputs on) → gradients by flax path."""
    state = port_state(model_type)
    model = state.model.double()
    for m in model.modules():
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = torch.float64
    video, audio, labels = (t.double() for t in _inputs(
        {k: torch.from_numpy(x) for k, x in batch.items()}, torch.device("cpu")))
    ce, _ = _ce_acc(model(video, audio, train=True), labels)
    (ce + l2_penalty(model)).backward()
    params = dict(model.named_parameters())
    grads = {}
    for name, coll, path, layout in avc_leaves(model_type):
        if coll == "params":
            g = params[name].grad.detach().numpy()
            grads[path] = g.transpose(2, 3, 1, 0) if layout == "conv" else g.T if layout == "dense" else g
    return grads


@pytest.mark.parametrize("rows", [4, 8])
def test_bn_fed_conv_bias_gradients_at_the_rounding_floor(rows):
    """tiny_L3's conv biases that feed a train-mode BN: in a float64 step
    their gradient is zero but for rounding (≤ 1e-12 of the fed BN's bias
    gradient; 4e-14 measured), and the f32 step keeps it ≤ 1e-4 of it
    (3.7e-5 at most; summed exactly, the f32 per-element gradients give
    1.6e-5-3.3e-5). The conv backward's own float32 bias sum put the vision
    Conv_0 bias at 1.7e-2 at 8 rows (JAX's step: 1.3e-4), above
    check_step's 1e-3 gate; towers._conv adds such a bias on its own."""
    batch = make_batch(rows, seed=7)
    f32, f64 = port_step("tiny_L3", batch)[2], float64_step_grads("tiny_L3", batch)
    for path, bn_bias in bn_fed_paths("tiny_L3").items():
        r32 = np.abs(f32[path]).max() / np.abs(f32[bn_bias]).max()
        r64 = np.abs(f64[path]).max() / np.abs(f64[bn_bias]).max()
        print("/".join(path), f"f32 {r32:.2e}, float64 {r64:.2e}")
        assert r64 <= 1e-12 and r32 <= 1e-4, (path, r32, r64)


def test_train_step_accum_tiny():
    """accum_steps=2: gradients averaged over the microbatches, BN
    statistics updated once per microbatch in sequence."""
    batch = make_batch(4, seed=3)
    ours = port_step("tiny_L3", batch, accum_steps=2)
    theirs = jax_step("tiny_L3", batch, accum_steps=2)
    check_metrics(ours[1], theirs[1], 1e-5)
    check_step("tiny_L3", ours, theirs)


def test_train_step_accum_needs_divisible_batch():
    state = port_state("tiny_L3")
    b = {k: torch.from_numpy(x) for k, x in make_batch(3).items()}
    with pytest.raises(ValueError, match="not divisible"):
        make_train_step(accum_steps=2)(state, b)


@pytest.fixture(scope="module")
def melspec2_bf16(melspec2_f32):
    """JAX's bf16 step on the f32 fixture's batch."""
    batch, _ = melspec2_f32
    return jax_step("cnn_L3_melspec2", batch, dtype=jnp.bfloat16)


def bf16_readings(ours, theirs, jax_f32_grads):
    """The numbers the bf16 gates read, port step against JAX's bf16 step:
    loss and reg_loss relative errors, accuracies, the largest relative
    error of a BN's batch statistics (read off the new running ones), and
    the mean distance (1 − cosine) of the port's and of JAX's bf16
    gradients from JAX's f32 ones, with the farthest leaf of > 1 element."""
    (o_trees, o_m, o_grads), (t_trees, t_m, t_grads) = ours, theirs
    old = dict(flat(variables("cnn_L3_melspec2")["batch_stats"]))
    t_stats = dict(flat(t_trees["batch_stats"]))
    stat_err = 0.0
    for path, o in flat(o_trees["batch_stats"]):
        # new = 0.99·old + 0.01·batch → the batch's own statistic.
        a, b = ((x - 0.99 * old[path]) / 0.01 for x in (o, t_stats[path]))
        stat_err = max(stat_err, np.abs(a - b).max() / np.abs(b).max())
    noise = bn_fed_paths("cnn_L3_melspec2")
    d = {path: (1 - cosine(o_grads[path], ref), 1 - cosine(t_grads[path], ref))
         for path, ref in jax_f32_grads.items() if path not in noise}
    wide = [v for path, v in d.items() if jax_f32_grads[path].size > 1]
    return {
        "loss_rel": abs(o_m["loss"] - t_m["loss"]) / abs(t_m["loss"]),
        "acc": (o_m["acc"], t_m["acc"]),
        "reg_rel": abs(o_m["reg_loss"] - t_m["reg_loss"]) / t_m["reg_loss"],
        "stat_err": stat_err,
        "dist": np.mean([o for o, _ in d.values()]),
        "dist_jax": np.mean([t for _, t in d.values()]),
        "farthest": max(o for o, _ in wide),
        "cos_range": (1 - max(o for o, _ in wide), 1 - min(o for o, _ in wide),
                      1 - max(t for _, t in wide), 1 - min(t for _, t in wide)),
    }


def bf16_failures(r):
    """The bf16 gates (module docstring) that readings `r` fail."""
    failed = [name for name, bad in (
        ("loss", r["loss_rel"] > 1e-2),
        ("acc", r["acc"][0] != r["acc"][1]),
        ("reg_loss", r["reg_rel"] > 1e-5),
        ("stats", r["stat_err"] > 2e-2),
        ("distance", r["dist"] > 1.5 * r["dist_jax"]),
        # No leaf past 0.25 but the input BN's one-element scale and bias.
        ("leaf", r["farthest"] > 0.25),
    ) if bad]
    return failed


def test_train_step_melspec2_bf16(melspec2_f32, melspec2_bf16):
    """One bf16 step (module docstring's gates): the loss within 1e-2, the
    same accuracy, reg_loss within 1e-5; each BN's batch statistics within
    2e-2 of JAX's bf16 step's, relative to the leaf's largest; the port's
    bf16 gradients no farther from JAX's f32 ones than 1.5 × JAX's bf16
    gradients are, in mean distance over the leaves, and no leaf of more
    than one element past 0.25."""
    batch, (_, _, jax_f32_grads) = melspec2_f32
    ours = port_step("cnn_L3_melspec2", batch, dtype=torch.bfloat16)
    r = bf16_readings(ours, melspec2_bf16, jax_f32_grads)
    print(f"bf16 metrics: port {ours[1]}, JAX {melspec2_bf16[1]}")
    print("bf16 step: mean distance from JAX f32 grads, port {dist:.4f}, JAX {dist_jax:.4f}; "
          "batch statistics max relative error {stat_err:.2e}; per-leaf cosine to JAX f32 "
          "(leaves of > 1 element), port {0:.4f}..{1:.4f}, JAX {2:.4f}..{3:.4f}".format(
              *r["cos_range"], **r))
    assert bf16_failures(r) == [], r


def _planted_bn(fault):
    """towers._bn with one fault planted in its bf16 train mode."""
    real = towers._bn

    def bn_(bn, x, dtype, train=False):
        if not train or dtype != torch.bfloat16:
            return real(bn, x, dtype, train)
        xs = x.to(torch.bfloat16) if fault == "BN statistics reduced in bf16" else x.float()
        if fault == "unbiased BN variance":
            var, mean = torch.var_mean(xs, (0, 2, 3), unbiased=True)
        else:
            mean = xs.mean((0, 2, 3))
            var = torch.clamp((xs * xs).mean((0, 2, 3)) - mean * mean, min=0.0)
        mean, var = mean.float(), var.float()
        with torch.no_grad():
            bn.running_mean.mul_(0.99).add_(mean, alpha=0.01)
            bn.running_var.mul_(0.99).add_(var, alpha=0.01)
        if fault == "BN batch mean detached":
            mean = mean.detach()
        if fault == "BN batch variance detached":
            var = var.detach()
        mul = torch.rsqrt(var + bn.eps) * bn.weight
        shape = (1, -1, 1, 1)
        return ((x.float() - mean.view(shape)) * mul.view(shape) + bn.bias.view(shape)).to(dtype)

    return bn_


def test_bf16_gates_catch_planted_faults(melspec2_f32, melspec2_bf16, monkeypatch):
    """Faults planted in the port's bf16 step, each read by the bf16 gates:
    BN statistics reduced in bf16 must fail the statistics gate, and the
    BN's batch mean detached from the gradient (loss and statistics as they
    were) the distance gate. The rest are printed: they lie within bf16's
    noise (PERF.md §6, training)."""
    batch, (_, _, jax_f32_grads) = melspec2_f32
    real_mel = towers.melspectrogram_fused
    faults = {
        "BN statistics reduced in bf16": "stats",
        "BN batch mean detached": "distance",
        "BN batch variance detached": None,
        "unbiased BN variance": None,
        "mel output rounded to bf16": None,
    }
    for fault, caught_by in faults.items():
        with monkeypatch.context() as m:
            if fault.startswith("mel"):
                m.setattr(towers, "melspectrogram_fused",
                          lambda x, cfg, fast: real_mel(x, cfg, fast).to(torch.bfloat16).float())
            else:
                m.setattr(towers, "_bn", _planted_bn(fault))
            r = bf16_readings(port_step("cnn_L3_melspec2", batch, dtype=torch.bfloat16),
                              melspec2_bf16, jax_f32_grads)
        failed = bf16_failures(r)
        print(f"{fault}: fails {failed}; loss rel {r['loss_rel']:.2e}, statistics "
              f"{r['stat_err']:.3f}, distance {r['dist']:.4f} = {r['dist'] / r['dist_jax']:.2f}x "
              f"JAX's, farthest leaf {r['farthest']:.3f}")
        if caught_by:
            assert caught_by in failed, (fault, r)


# ---------------------------------------------------------------- eval, L2, batch

@pytest.mark.parametrize("model_type", ["tiny_L3", "cnn_L3_melspec2"])
def test_eval_step(model_type):
    """Eval-mode BN, loss = cross-entropy + L2, against make_eval_step."""
    v = variables(model_type)
    batch = make_batch(2, seed=5)
    model = jax_build_model(model_type).module()
    tx = make_optimizer(LR)
    state = AVCTrainState(
        step=jnp.zeros((), jnp.int32), params=v["params"], batch_stats=v["batch_stats"],
        opt_state=tx.init(v["params"]), tx=tx,
    )
    theirs = {k: float(x) for k, x in jax_make_eval_step(model)(state, batch).items()}
    ours_state = port_state(model_type)
    before = {k: t.clone() for k, t in ours_state.model.state_dict().items()}
    ours = make_eval_step()(ours_state, {k: torch.from_numpy(x) for k, x in batch.items()})
    ours = {k: float(x) for k, x in ours.items()}
    assert ours["acc"] == theirs["acc"]
    assert abs(ours["loss"] - theirs["loss"]) <= 1e-5 * abs(theirs["loss"])
    for k, t in ours_state.model.state_dict().items():
        assert torch.equal(t, before[k]), k


@pytest.mark.parametrize("model_type", ["tiny_L3", "cnn_L3_orig", "cnn_L3_melspec2"])
def test_l2_penalty(model_type):
    """1e-5 · Σ w² over conv and dense kernels only, as JAX's."""
    v = variables(model_type)
    model = port_state(model_type).model
    want = float(jax_l2_penalty(v["params"]))
    got = float(l2_penalty(model).detach())
    assert abs(got - want) <= 1e-6 * want
    # BN scales, BN biases and conv/dense biases do not count.
    with torch.no_grad():
        for name, p in model.named_parameters():
            if not name.endswith("weight") or ".bn" in name or "_bn" in name or "bns." in name:
                p.add_(1.0)
    assert float(l2_penalty(model).detach()) == got
    with torch.no_grad():
        model.merge_dense.weight.mul_(2.0)
    assert float(l2_penalty(model).detach()) > got


def test_preprocess_batch():
    b = make_batch(2)
    v, a = preprocess_batch(torch.from_numpy(b["video"]), torch.from_numpy(b["audio"]))
    jv, ja = jax_preprocess_batch(jnp.asarray(b["video"]), jnp.asarray(b["audio"]))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    assert v.dtype == torch.float32 and a.dtype == torch.float32
    # Floats pass through unchanged.
    v2, a2 = preprocess_batch(v, a)
    assert v2 is v and a2 is a


def test_bn_modes():
    """per_replica needs no group (one rank: the sync step,
    tests/test_torch_port_parallel.py) but refuses gradient accumulation,
    as JAX's does; an unknown mode raises."""
    make_train_step(bn_mode="per_replica")
    with pytest.raises(NotImplementedError, match="gradient accumulation"):
        make_train_step(accum_steps=2, bn_mode="per_replica")
    with pytest.raises(ValueError, match="unknown bn_mode"):
        make_train_step(bn_mode="global")


def test_create_train_state_defaults_to_cuda():
    import inspect

    from l3embedding_torch.training import loop, state

    assert inspect.signature(state.create_train_state).parameters["device"].default == "cuda"
    assert inspect.signature(loop.train).parameters["device"].default == "cuda"
