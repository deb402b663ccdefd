"""The port's tensor parallelism (``l3embedding_torch/parallel/tp.py``, the
mesh's ``model`` axis) against the JAX package's ``tp_shard_state`` and
against the port's own one-process step, on the CPU.

One 4-rank gloo job on a (data 2, model 2) mesh
(``tests/torch_port_tp_worker.py``, ``OMP_NUM_THREADS=1``) is started once
for the module and leaves its results in ckpt, npz and JSON files:

  * tiny_L3 from JAX's initial parameters (``PRNGKey(0)``, learning rate
    1e-3) on the 16-row batch of ``tests/test_parallel.py``'s ``setup``,
    against JAX's ``tp_shard_state`` step on ``create_mesh(model_axis=2)``
    (data 4 × model 2 of the 8 virtual CPU devices): the plain step, an
    ``accum_steps=2`` step and a ``db_batch_global`` step;
  * cnn_L3_melspec2 at 4 rows (``test_torch_port_train.variables``) against
    the port's one-process step: the block-4 and row-parallel embedding-conv
    rules, which tiny does not have.

Gates: those of ``test_torch_port_train.py`` (the loss, accuracy and L2
term within 1e-5 relative, the same accuracy, every gathered gradient leaf,
Adam moment, new parameter and new BN statistic at cosine >= 0.99999 with
its norm within 2 %, the BN-fed conv biases held to their rounding floor).
The checkpoints a TP run writes hold the whole state: they restore in one
process and through JAX's ``load_state`` bit for bit, and load back onto
the mesh to the same slices. Without a launch: the rules, each rank's
slices against JAX's shards, the rank grid and the refusals.
"""

import functools
import hashlib
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from l3embedding_tpu.models import build_model as jax_build_model
from l3embedding_tpu.parallel import create_mesh as jax_create_mesh
from l3embedding_tpu.parallel import shard_batch as jax_shard_batch
from l3embedding_tpu.parallel.tp import tp_shard_state as jax_tp_shard_state
from l3embedding_tpu.training import checkpoints as jax_ckpt
from l3embedding_tpu.training.state import AVCTrainState, make_optimizer
from l3embedding_tpu.training.state import create_train_state as jax_create_train_state
from l3embedding_tpu.training.steps import make_train_step as jax_make_train_step
from l3embedding_torch.compat.from_jax import avc_from_jax_variables, avc_leaves, to_torch_layout
from l3embedding_torch.models.towers import model_split
from l3embedding_torch.parallel import ProcessMesh, rank_grid
from l3embedding_torch.parallel.tp import split_leaves, tp_mesh, tp_shard_state
from l3embedding_torch.training import checkpoints
from l3embedding_torch.training.dir_checkpoints import load_state_dir
from l3embedding_torch.training.steps import make_train_step

from test_torch_port_train import (
    LR,
    bn_fed_paths,
    check_metrics,
    check_step,
    cosine,
    flat,
    float64_step_grads,
    make_batch,
    port_state,
    port_step,
    variables,
)
from test_torch_port_trainloop import assert_trees_equal
from torch_port_threads import one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
TINY_LR = 1e-3  # tests/test_parallel.py's setup
TINY_SCENARIOS = {"tp": (1, False), "tp_accum2": (2, False), "tp_db_global": (1, True)}
RANKS = 4


def setup_batch():
    """tests/test_parallel.py's ``setup`` batch: 16 rows from seed 0."""
    rng = np.random.RandomState(0)
    batch = {
        "video": rng.randint(0, 256, size=(16, 224, 224, 3)).astype(np.uint8),
        "audio": (rng.randn(16, 1, 48000) * 3000).astype(np.int16),
        "label": np.stack([rng.randint(0, 2, 16)] * 2, axis=1).astype(np.float32),
    }
    batch["label"][:, 1] = 1 - batch["label"][:, 0]
    return batch


@functools.cache
def jax_tiny_state():
    spec = jax_build_model("tiny_L3")
    return jax_create_train_state(spec.module(), jax.random.PRNGKey(0), spec.video_input_shape,
                                  spec.audio_input_shape, learning_rate=TINY_LR)


def jax_state_of(variables_np, lr):
    tx = make_optimizer(lr)
    return AVCTrainState(step=jnp.zeros((), jnp.int32), params=variables_np["params"],
                         batch_stats=variables_np["batch_stats"], opt_state=tx.init(variables_np["params"]),
                         tx=tx)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The 4-rank job's work dir, after every rank exited 0."""
    work = tmp_path_factory.mktemp("tp")
    jax_ckpt.save_state(str(work / "tiny_state0.ckpt"), jax_tiny_state())
    jax_ckpt.save_state(str(work / "mel_state0.ckpt"), jax_state_of(variables("cnn_L3_melspec2"), LR))
    np.savez(work / "tiny_batch.npz", **setup_batch())
    np.savez(work / "mel_batch.npz", **make_batch(4, seed=7))
    port = _free_port()
    procs = []
    for rank in range(RANKS):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(RANKS), LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE=str(RANKS), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_port_tp_worker.py"), str(work)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=400)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} exited {p.returncode}:\n{out[-4000:]}"
    return work


@pytest.fixture(scope="module")
def records(job):
    return [json.loads((job / "out" / f"rank{r}.json").read_text()) for r in range(RANKS)]


def job_step(job, name):
    """→ (trees, metrics, grads) of a scenario, in the layout of
    ``test_torch_port_train.check_step``: the state rank 0 wrote, the
    gathered gradients."""
    tree = checkpoints.read_tree(str(job / "out" / f"{name}.ckpt"))
    trees = {"params": tree["params"], "batch_stats": tree["batch_stats"], "mu": tree["opt_state"]["0"]["mu"]}
    with np.load(job / "out" / f"{name}.npz") as z:
        metrics = {k[7:]: float(z[k]) for k in z.files if k.startswith("metric:")}
        grads = {tuple(k[5:].split("/")): z[k] for k in z.files if k.startswith("grad:")}
    return trees, metrics, grads


@pytest.fixture(scope="module")
def jax_tp_steps():
    """JAX's step on its (data 4, model 2) mesh, the state placed by its
    tp_shard_state, per tiny scenario → (trees, metrics, grads)."""
    mesh = jax_create_mesh(model_axis=2)
    batch = jax_shard_batch(setup_batch(), mesh)
    out = {}
    for name, (accum_steps, db_batch_global) in TINY_SCENARIOS.items():
        model = jax_build_model("tiny_L3").module(db_batch_global=db_batch_global)
        step = jax_make_train_step(model, donate=False, accum_steps=accum_steps, mesh=mesh)
        new, metrics = step(jax_tp_shard_state(jax_tiny_state(), mesh), batch)
        host = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
        trees = {"params": host(new.params), "batch_stats": host(new.batch_stats),
                 "mu": host(new.opt_state[0].mu)}
        grads = {path: mu / 0.1 for path, mu in flat(trees["mu"])}
        out[name] = (trees, {k: float(x) for k, x in metrics.items()}, grads)
    return out


def _gates(model_type, ours, theirs, old_params=None, lr=LR, grad_gate=0.99999):
    check_metrics(ours[1], theirs[1], 1e-5)
    assert ours[1]["acc"] == theirs[1]["acc"]
    return check_step(model_type, ours, theirs, grad_gate, old_params=old_params, lr=lr)


# ---------------------------------------------------------------- without a launch

@pytest.mark.parametrize("data,model", [(4, 1), (2, 2), (1, 4)])
def test_rank_grid_is_jax_device_grid(data, model):
    """Rank d·M + m sits where JAX's create_mesh puts device d·M + m."""
    n = data * model
    jax_grid = jax_create_mesh(jax.devices()[:n], model_axis=model).devices
    np.testing.assert_array_equal(rank_grid(n, model), np.vectorize(lambda d: d.id)(jax_grid))


def test_rank_grid_refuses_an_uneven_model_axis():
    with pytest.raises(ValueError) as theirs:
        jax_create_mesh(jax.devices()[:6], model_axis=4)
    with pytest.raises(ValueError) as ours:
        rank_grid(6, 4)
    assert str(ours.value) == str(theirs.value) == "6 devices not divisible by model_axis=4"


@pytest.mark.parametrize("model_type,at_least", [("tiny_L3", 5), ("cnn_L3_melspec2", 11)])
def test_rules_split_the_leaves_jax_splits(model_type, at_least):
    """The port's rules split exactly the parameters and statistics that
    JAX's tp_shard_state places on the model axis (test_parallel.py's
    test_tp_rules_fire_on_tiny_and_full counts: >= 5 and >= 11 parameters)."""
    mesh = jax_create_mesh(jax.devices()[:8], model_axis=2)
    placed = jax_tp_shard_state(jax_state_of(variables(model_type), LR), mesh)
    theirs = set()
    for coll in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(getattr(placed, coll))[0]:
            if any(s is not None for s in leaf.sharding.spec):
                theirs.add((coll,) + tuple(k.key for k in path))
    paths = {name: (coll,) + path for name, coll, path, _ in avc_leaves(model_type)}
    ours = {paths[name] for name in split_leaves(model_type)}
    assert ours == theirs
    assert sum(p[0] == "params" for p in ours) >= at_least


@pytest.mark.parametrize("model_index", [0, 1])
@pytest.mark.parametrize("model_type", ["tiny_L3", "cnn_L3_melspec2"])
def test_slices_equal_jax_shards(model_type, model_index):
    """After tp_shard_state, rank m's slice of every split parameter and
    statistic is the shard JAX's tp_shard_state puts on model index m (in
    the torch layout); the replicated leaves are whole; the split layers
    carry their kinds; a second split is refused."""
    v = variables(model_type)
    mesh = jax_create_mesh(jax.devices()[:8], model_axis=2)
    placed = jax_tp_shard_state(jax_state_of(v, LR), mesh)
    state = port_state(model_type)
    whole = {**dict(state.model.named_parameters()), **dict(state.model.named_buffers())}
    whole = {k: t.clone() for k, t in whole.items()}
    tp_shard_state(state, ProcessMesh(data=1, model=2, model_index=model_index))
    assert tp_mesh(state.model).model_index == model_index
    ours = {**dict(state.model.named_parameters()), **dict(state.model.named_buffers())}
    split = split_leaves(model_type)
    device = mesh.devices[0, model_index]
    for name, coll, path, layout in avc_leaves(model_type):
        leaf = placed.params if coll == "params" else placed.batch_stats
        for k in path:
            leaf = leaf[k]
        if name in split:
            (shard,) = [s for s in leaf.addressable_shards if s.device == device]
            assert torch.equal(ours[name], to_torch_layout(np.asarray(shard.data), layout)), name
            assert ours[name].shape[split[name]] * 2 == whole[name].shape[split[name]]
        else:
            assert torch.equal(ours[name], whole[name]), name
    kinds = {n: model_split(m).kind for n, m in state.model.named_modules() if model_split(m) is not None}
    if model_type == "tiny_L3":
        assert kinds == {"audio_model.convs.2": "gather", "vision_model.convs.2": "gather", "merge_dense": "row"}
    else:
        assert kinds == {f"{t}_model.{layer}": kind for t in ("audio", "vision")
                         for layer, kind in (("blocks.6.conv", "column"), ("embedding_conv", "row"))} | {
            "merge_dense": "row"}
    assert [p.shape for p in state.optimizer.param_groups[0]["params"]] == [
        p.shape for p in state.model.parameters()]
    with pytest.raises(ValueError, match="split over a model axis already"):
        tp_shard_state(state, ProcessMesh(data=1, model=2))


def test_per_replica_refuses_a_model_axis():
    """As JAX's _make_per_replica_train_step: per_replica BN on a mesh with
    a model axis raises; sync builds."""
    with pytest.raises(ValueError, match="per_replica BN supports data-parallel meshes only"):
        make_train_step(bn_mode="per_replica", group=ProcessMesh(data=1, model=2))
    make_train_step(group=ProcessMesh(data=1, model=2))
    make_train_step(bn_mode="per_replica", group=ProcessMesh(data=1, model=1))


# ---------------------------------------------------------------- the 4-rank job

def test_mesh_of_each_rank(records):
    assert [r["mesh"] for r in records] == [[2, 2, 0, 0], [2, 2, 0, 1], [2, 2, 1, 0], [2, 2, 1, 1]]


@pytest.mark.parametrize("name", list(TINY_SCENARIOS))
def test_tiny_tp_step_equals_jax_tp_mesh(job, jax_tp_steps, name):
    """tiny_L3 on the (data 2, model 2) mesh against JAX's tp_shard_state
    step on (data 4, model 2): the plain, accumulated (JAX's microbatches)
    and db_batch_global steps at every gate."""
    old = jax.tree.map(np.asarray, jax_tiny_state().params)
    worst = _gates("tiny_L3", job_step(job, name), jax_tp_steps[name], old_params=old, lr=TINY_LR)
    print(f"{name}: TP (data 2, model 2) vs JAX's TP mesh, worst:", worst)


def test_second_tiny_tp_step_is_finite(records):
    seconds = [r["second_step"] for r in records]
    assert all(s == seconds[0] for s in seconds)
    assert np.isfinite(list(seconds[0].values())).all()


def test_melspec2_tp_step_equals_one_process_and_float64(job):
    """cnn_L3_melspec2 at 4 rows on the mesh (2 rows a data index; the
    block-4 conv, its BN and the embedding convs split), as
    test_torch_port_train.py holds its melspec2 steps: every gradient leaf
    against the same step in float64 at cosine 0.99999, and against the
    port's one-process f32 step on the 4 rows at every gate, the gradients
    at 0.99997, as two f32 steps of another arithmetic order are held there.
    Measured: the vision input BN's scale gradient at 0.9999991 from
    float64 under TP, 0.9999831 in the one-process step, 0.9999899 between
    the two; the TP step's worst leaf against float64 0.9999958."""
    batch = make_batch(4, seed=7)
    ours = job_step(job, "tp_mel")
    worst = _gates("cnn_L3_melspec2", ours, port_step("cnn_L3_melspec2", batch), grad_gate=0.99997)
    print("melspec2: TP (data 2, model 2) vs one process, worst:", worst)
    noise = bn_fed_paths("cnn_L3_melspec2")
    f64 = float64_step_grads("cnn_L3_melspec2", batch)
    rows = sorted((cosine(ours[2][p], g), "/".join(p)) for p, g in f64.items() if p not in noise)
    print("melspec2: TP vs float64, worst:", rows[:3])
    assert rows[0][0] >= 0.99999, rows[0]


def _slice_digests(ckpt, model_type, model_index):
    """SHA-256 of model index m's slice of each split leaf of a whole
    ``.ckpt``, in the torch layout."""
    sd = avc_from_jax_variables(checkpoints.read_tree(str(ckpt)), model_type)
    out = {}
    for name, dim in split_leaves(model_type).items():
        t = sd[name]
        k = t.shape[dim] // 2
        out[name] = hashlib.sha256(t.narrow(dim, model_index * k, k).contiguous().numpy().tobytes()).hexdigest()
    return out


@pytest.mark.parametrize("name", list(TINY_SCENARIOS) + ["tp_mel"])
def test_rank_slices_are_the_gathered_state(job, records, name):
    """After each step: every rank's replicated leaves are equal, and each
    rank's split slices are its model index's slices of the gathered state
    (bit for bit), the same on both data indices."""
    model_type = "cnn_L3_melspec2" if name == "tp_mel" else "tiny_L3"
    assert len({r[name]["replicated"] for r in records}) == 1
    for r in records:
        want = _slice_digests(job / "out" / f"{name}.ckpt", model_type, r["mesh"][3])
        assert {k: v for k, v in r[name].items() if k != "replicated"} == want


def test_eval_step_equals_pure_dp(records):
    """The TP eval step's metrics are pure data parallelism's on the same 4
    ranks, and every rank reports the same."""
    assert all(r["eval_tp"] == records[0]["eval_tp"] for r in records)
    tp, dp = records[0]["eval_tp"], records[0]["eval_dp"]
    assert abs(tp["loss"] - dp["loss"]) <= 1e-6 * abs(dp["loss"])
    assert tp["acc"] == dp["acc"]


def test_tp_checkpoint_restores_in_one_process_jax_and_on_the_mesh(job, records):
    """The .ckpt written under TP holds the whole state: the port restores
    it in one process and JAX's load_state restores it, both bit for bit
    against the file; loaded back onto the mesh it gives every rank its
    slices again."""
    path = str(job / "out" / "tp.ckpt")
    tree = checkpoints.read_tree(path)
    state = port_state("tiny_L3")
    checkpoints.load_state(path, state)
    assert state.step == 1
    assert_trees_equal(checkpoints.state_tree(state), tree)
    theirs = jax.tree.map(np.asarray, jax_ckpt.load_state(path, jax_tiny_state()))
    assert int(theirs.step) == 1
    assert_trees_equal(tree["params"], theirs.params)
    assert_trees_equal(tree["batch_stats"], theirs.batch_stats)
    assert_trees_equal(tree["opt_state"]["0"]["mu"], theirs.opt_state[0].mu)
    assert_trees_equal(tree["opt_state"]["0"]["nu"], theirs.opt_state[0].nu)
    for r in records:
        assert r["reloaded"] == r["tp"] and r["reloaded_step"] == 1


def test_tp_directory_snapshot_restores_in_one_process(job):
    """The tiny step's state, saved under TP by all 4 ranks as one directory
    snapshot, restores in one process to the .ckpt of the same state."""
    state = port_state("tiny_L3")
    load_state_dir(str(job / "out" / "tp_dir"), state)
    assert state.step == 1
    assert_trees_equal(checkpoints.state_tree(state), checkpoints.read_tree(str(job / "out" / "tp.ckpt")))
