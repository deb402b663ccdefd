"""The plain reference agrees with the program on the CPU: extraction rows
at 2 windows, and a train step on 2 pairs; and a batch spread over several
devices is stepped as one batch. (A test may import both; the reference
itself imports nothing of the program.)"""

import json

import numpy as np
import pytest
import torch

from l3bench import check, generate, run, weights
from l3bench.drivers import _port, train
from l3bench.generators import avc_batches, clips
from l3bench.reference import model as ref


def config(name):
    return json.loads((run.HERE / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name,pooling,dim", [("cnn_L3_melspec2", "short", 512), ("cnn_L3_orig", "original", 6144)])
def test_extraction_rows_agree_at_two_windows(name, pooling, dim):
    from l3embedding_torch.models.embedding import audio_embedding_fn

    cfg = config(name)
    params = weights.make(ref.param_specs(cfg, ("audio",)), 21, "cpu")
    fn = audio_embedding_fn(name, pooling)
    _port.load(fn.tower, params, {"audio": ""})
    stream = clips.ClipStream(generate.load_mix("clips10s"), 21)
    x = torch.from_numpy(ref.frame_windows(stream.pool[:52800], 48000, 0.1))
    assert x.shape == (2, 48000)
    with torch.no_grad():
        got = fn(x).numpy()
    want = ref.audio_embedding(params, x, cfg, pooling).numpy()
    assert got.shape == want.shape == (2, dim)
    assert check.row_err(got, want) < 1e-5


def test_frame_windows_match_the_program():
    from l3embedding_torch.embed.extract import frame_uniform

    audio = np.random.default_rng(0).standard_normal(48000 * 3 + 1234).astype(np.float32)
    for n in (30000, 48000, 52800, 48000 * 3 + 1234, 480_000):
        if n <= len(audio):
            assert np.array_equal(ref.frame_windows(audio[:n], 48000, 0.1), frame_uniform(audio[:n], 48000, 0.1))


def _batches(rows, n, seed=4):
    mix = {**generate.load_mix("avc_rows256"), "rows_per_card": rows, "pool": n}
    return avc_batches.avc_pool(mix, seed, "cpu", 1)


def test_train_step_agrees_on_two_pairs():
    from l3embedding_torch.models.registry import build_model
    from l3embedding_torch.training.state import TrainState, make_optimizer
    from l3embedding_torch.training.steps import make_train_step

    cfg = config("cnn_L3_melspec2")
    params = weights.make(ref.param_specs(cfg), 4, "cpu")
    batch = _batches(2, 1)[0]
    model = build_model("cnn_L3_melspec2").module()
    _port.load(model, params)
    opt = make_optimizer(model, cfg["adam"]["learning_rate"])
    emb = {}
    hooks = train._tower_hooks(model, emb)
    state, metrics = make_train_step()(TrainState(0, model, opt, "cnn_L3_melspec2"), batch)
    for h in hooks:
        h.remove()
    trainable = [n for n in params if not ref.is_running_stat(n)]
    prog = {"loss": [float(metrics["loss"] + metrics["reg_loss"])],
            "grad1": {n: opt.state[model.get_parameter(_port.port_name(n))]["exp_avg"] / 0.1 for n in trainable},
            "emb1": emb, "params": _port.read(model, params)}
    want = ref.train_steps(params, [batch], cfg, "f32")
    numbers = check.train_numbers(prog, want, params)
    assert numbers["loss_gap"] < 1e-6
    assert numbers["emb_err"] < 1e-4
    assert numbers["grad_gap"] < 1e-4
    # Adam's first step moves an element by lr * g / (|g| + 1e-8): elements
    # whose gradient is near 1e-8 move by amounts that two float32 orders
    # set apart, so a BatchNorm offset's change parts at ~5e-5 of its norm.
    assert numbers["change_gap"] < 1e-3
    # The worst gradient leaf sums products that cancel over the batch (a
    # BatchNorm's scale or offset): two float32 orders part at ~2e-3 of it.
    assert numbers["grad_gap_worst_leaf"] < 1e-2


def test_a_batch_spread_over_devices_is_stepped_as_one_batch():
    # Two parts of two rows each (both on the CPU here; on the card each on
    # a card of its own) against the four rows as one part: the BatchNorms
    # see all four rows, the loss is their mean.
    cfg = config("cnn_L3_melspec2")
    params = weights.make(ref.param_specs(cfg), 6, "cpu")
    batches = _batches(4, 2, seed=6)
    one = ref.train_steps(params, batches, cfg, "f32")
    two = ref.train_steps(params, batches, cfg, "f32", devices=["cpu", "cpu"])
    numbers = check.train_numbers(two, one, params)
    # Float32 sums in another order; Adam's first steps move an element by
    # about lr whatever its gradient, so elements whose gradient is near 0
    # move apart, and the later steps' losses part at some parts in 1e5.
    assert numbers["loss_gap"] < 1e-6 and numbers["loss_gap_any_step"] < 1e-4, numbers
    assert numbers["emb_err"] < 1e-5, numbers
    assert numbers["grad_gap"] < 1e-5 and numbers["change_gap"] < 1e-3, numbers
