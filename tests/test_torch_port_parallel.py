"""The port's data-parallel training (``l3embedding_torch/parallel``, the
process-group paths of ``training/steps.py`` and ``training/loop.py``)
against one process and against the JAX package on the CPU.

One 2-rank gloo job on tiny_L3 (``tests/torch_port_parallel_worker.py``,
``OMP_NUM_THREADS=1``) is started once for the module and leaves its results
in npz, ckpt and JSON files; JAX's steps run in this process on 2 of the 8
virtual CPU devices, from the same seeded step-0 state and the same global
batches of 4 and 8 rows (``test_torch_port_train.variables``, He-scaled
kernels, BN statistics away from the identity): the sync step, at 4 and 8
rows, with gradient accumulation (JAX's microbatches of the global batch)
and on a db_batch_global model (one reference over every rank's rows).

Gates (those of ``test_torch_port_train.py``): the loss within 1e-5
relative, the same accuracy, every gradient leaf, Adam moment, new
parameter and new BN statistic at cosine >= 0.99999 with its norm within
2 %; a conv bias that feeds a train-mode BN has a gradient that is zero but
for rounding and is held to that instead. Each planted fault (a moment
reduction autograd does not see, per-rank variances averaged, DDP's
``broadcast_buffers`` under ``per_replica``, each rank's own dB reference
under db_batch_global) must fail one of them. The job also saves the sync
step's state as a directory snapshot from both ranks
(``training/dir_checkpoints.py``), which restores in this one process.
"""

import json
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from l3embedding_tpu.models import build_model as jax_build_model
from l3embedding_tpu.parallel import create_mesh
from l3embedding_tpu.parallel import replicate as jax_replicate
from l3embedding_tpu.parallel import shard_batch as jax_shard_batch
from l3embedding_tpu.training import checkpoints as jax_ckpt
from l3embedding_tpu.training import data as jax_data
from l3embedding_tpu.training.state import AVCTrainState, make_optimizer
from l3embedding_tpu.training.steps import make_train_step as jax_make_train_step
from l3embedding_torch import parallel
from l3embedding_torch.parallel import distributed as pdist
from l3embedding_torch.training import checkpoints, data
from l3embedding_torch.training.loop import train
from l3embedding_torch.training.steps import make_eval_step, make_train_step

from test_torch_port_train import LR, check_metrics, check_step, flat, make_batch, port_step, variables
from test_torch_port_trainloop import assert_trees_equal, jax_template, make_corpus
from torch_port_threads import one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
MODEL = "tiny_L3"
BATCH = 4
FAULTS = ("fault_detached", "fault_var_avg", "fault_broadcast_buffers", "fault_db_local")


def quiet_batch():
    """8 rows whose last 4 (rank 1's) are 60 dB below the first 4: under
    db_batch_global their dB sits against rank 0's reference, mostly at the
    −80 floor, and each rank's own reference would move every value."""
    batch = make_batch(8, seed=5)
    batch["audio"][4:] = (batch["audio"][4:] // 1000).astype(np.int16)
    return batch


GLOBAL_BATCHES = {"batch": lambda: make_batch(BATCH, seed=7), "batch8": lambda: make_batch(8, seed=7),
                  "batch8_quiet": quiet_batch}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_state0():
    v = variables(MODEL)
    tx = make_optimizer(LR)
    return AVCTrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                         batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]), tx=tx)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The 2-rank job's work dir, after both ranks exited 0."""
    work = tmp_path_factory.mktemp("dp")
    jax_ckpt.save_state(str(work / "state0.ckpt"), _jax_state0())
    for name, make in GLOBAL_BATCHES.items():
        np.savez(work / f"{name}.npz", **make())
    make_corpus(str(work / "train_h5"), 3, 16, 0)
    make_corpus(str(work / "valid_h5"), 2, 8, 1)
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_port_parallel_worker.py"), str(work)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} exited {p.returncode}:\n{out[-4000:]}"
    return work


def ranks_result(job, name):
    """→ [(trees, metrics, grads) of rank 0, of rank 1] of a step scenario,
    in the layout of ``test_torch_port_train.check_step``."""
    out = []
    for rank in range(2):
        tree = checkpoints.read_tree(str(job / "out" / f"{name}_rank{rank}.ckpt"))
        trees = {"params": tree["params"], "batch_stats": tree["batch_stats"],
                 "mu": tree["opt_state"]["0"]["mu"]}
        with np.load(job / "out" / f"{name}_rank{rank}.npz") as z:
            metrics = {k[7:]: float(z[k]) for k in z.files if k.startswith("metric:")}
            grads = {tuple(k[5:].split("/")): z[k] for k in z.files if k.startswith("grad:")}
        out.append((trees, metrics, grads))
    return out


def jax_mesh_step(bn_mode, batch="batch", accum_steps=1, db_batch_global=False):
    """JAX's step on a 2-device ('data', 'model') mesh, the batch sharded
    over 'data' → (trees, metrics, grads) like ``port_step``."""
    mesh = create_mesh(jax.devices()[:2])
    model = jax_build_model(MODEL).module(db_batch_global=db_batch_global)
    state = jax_replicate(_jax_state0(), mesh)
    step = jax_make_train_step(model, donate=False, accum_steps=accum_steps, bn_mode=bn_mode, mesh=mesh)
    new, metrics = step(state, jax_shard_batch(GLOBAL_BATCHES[batch](), mesh))
    host = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    trees = {"params": host(new.params), "batch_stats": host(new.batch_stats),
             "mu": host(new.opt_state[0].mu)}
    grads = {path: mu / 0.1 for path, mu in flat(trees["mu"])}
    return trees, {k: float(x) for k, x in metrics.items()}, grads


@pytest.fixture(scope="module")
def jax_steps():
    return {"sync": jax_mesh_step("sync"), "per_replica": jax_mesh_step("per_replica"),
            "sync8": jax_mesh_step("sync", "batch8"), "accum2": jax_mesh_step("sync", "batch8", accum_steps=2),
            "db_global": jax_mesh_step("sync", "batch8_quiet", db_batch_global=True)}


def _gates(ours, theirs):
    """The gates of the module docstring, and each BN's batch statistics
    (read off the new running ones, new = 0.99·old + 0.01·batch) within
    1e-3 relative to the leaf's largest; → the worst readings."""
    check_metrics(ours[1], theirs[1], 1e-5)
    assert ours[1]["acc"] == theirs[1]["acc"]
    worst = check_step(MODEL, ours, theirs)
    old = dict(flat(variables(MODEL)["batch_stats"]))
    want = dict(flat(theirs[0]["batch_stats"]))
    for path, o in flat(ours[0]["batch_stats"]):
        a, b = ((x - 0.99 * old[path]) / 0.01 for x in (o, want[path]))
        err = np.abs(a - b).max() / np.abs(b).max()
        worst["batch_stat_err"] = max(worst.get("batch_stat_err", 0.0), err)
        assert err <= 1e-3, ("batch statistics", "/".join(path), err)
    return worst


# ---------------------------------------------------------------- set-up

def test_initialize_distributed_reads_the_environment(monkeypatch):
    """A single process is a no-op (False); a job of several reads WORLD_SIZE
    and RANK and needs MASTER_ADDR / MASTER_PORT or an init_method; the
    backend is gloo without a card; local_device is cuda:LOCAL_RANK and the
    CPU only when asked."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert parallel.initialize_distributed() is False
    assert parallel.world_size() == 1 and parallel.rank() == 0 and parallel.data_group() is None
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert parallel.initialize_distributed() is False
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="needs this process's rank"):
        parallel.initialize_distributed()
    monkeypatch.setenv("RANK", "1")
    with pytest.raises(ValueError, match="MASTER_ADDR and MASTER_PORT"):
        parallel.initialize_distributed()
    assert pdist.default_backend(2) == ("nccl" if torch.cuda.device_count() >= 2 else "gloo")
    assert pdist.default_backend(torch.cuda.device_count() + 1) == "gloo"
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert parallel.local_rank() == 3
    assert parallel.local_device("cpu") == torch.device("cpu")
    assert parallel.local_device("cuda:1") == torch.device("cuda", 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            parallel.local_device()


def test_shard_batch_rows_equal_jax():
    """Rank r's rows of a global batch are device r's shard under JAX's
    P('data'); the per-process form checks the per-rank size."""
    batch = make_batch(BATCH, seed=3)
    sharded = jax_shard_batch(batch, create_mesh(jax.devices()[:2]))

    class Group:  # a stand-in for a 2-rank group as this rank sees it
        pass

    for rank in range(2):
        with pytest.MonkeyPatch.context() as m:
            m.setattr(parallel.mesh.dist, "get_world_size", lambda g: 2)
            m.setattr(parallel.mesh.dist, "get_rank", lambda g, r=rank: r)
            ours = parallel.shard_batch(batch, Group())
            for k, x in ours.items():
                (shard,) = [s for s in sharded[k].addressable_shards if s.device == jax.devices()[rank]]
                np.testing.assert_array_equal(x, np.asarray(shard.data))
            assert parallel.shard_batch_local(ours, BATCH, Group()) is ours
            with pytest.raises(ValueError, match=f"want {BATCH // 2}"):
                parallel.shard_batch_local(batch, BATCH, Group())
            with pytest.raises(ValueError, match="not divisible by 2 ranks"):
                parallel.shard_batch({"x": np.zeros((3, 1))}, Group())
    assert parallel.shard_batch(batch) is batch


def test_model_axis_raises():
    """Without a group: no data group at model_axis=1; a model axis that
    one process cannot hold raises JAX's create_mesh message (the rank grid
    and the mesh's other refusals: tests/test_torch_port_tp.py)."""
    assert parallel.data_group(model_axis=1) is None
    with pytest.raises(ValueError, match="1 devices not divisible by model_axis=2"):
        parallel.data_group(model_axis=2)


@pytest.mark.parametrize("shard_index", [0, 1])
def test_rank_data_shards_equal_jax(tmp_path_factory, shard_index):
    """Each rank's data_generator(shard_index=rank, shard_count=2) yields
    JAX's batches for that process, in JAX's order, fast-forward included."""
    root = tmp_path_factory.mktemp("shards")
    make_corpus(str(root / "c"), 3, 8, 4)
    for start in (None, 3):
        kw = dict(batch_size=4, random_state=5, start_batch_idx=start, shard_index=shard_index,
                  shard_count=2)
        ours, theirs = data.data_generator(str(root / "c"), **kw), jax_data.data_generator(str(root / "c"), **kw)
        for _ in range(5):
            a, b = next(ours), next(theirs)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------- steps

def test_sync_step_equals_one_process_and_jax_mesh(job, jax_steps):
    """The 2-rank sync step: both ranks hold the same state after it; it
    equals the one-process step on the whole batch and JAX's step on a
    2-device mesh at every gate."""
    r0, r1 = ranks_result(job, "sync")
    assert r0[1] == r1[1]
    assert_trees_equal(r0[0], r1[0])
    single = port_step(MODEL, make_batch(BATCH, seed=7))
    print("2 ranks vs one process, worst:", _gates(r0, single))
    print("2 ranks vs JAX's 2-device mesh, worst:", _gates(r0, jax_steps["sync"]))


def test_sync_step_at_8_rows_equals_one_process_and_jax_mesh(job, jax_steps):
    """The 2-rank sync step at a global batch of 8 (4 rows a rank) against
    the one-process step and JAX's mesh step: every gate, the BN-fed conv
    biases' 1e-3 noise gate included, which the one-process step and JAX's
    both pass too (check_step holds both sides to it)."""
    r0, r1 = ranks_result(job, "sync8")
    assert_trees_equal(r0[0], r1[0])
    print("8 rows, 2 ranks vs one process, worst:", _gates(r0, port_step(MODEL, make_batch(8, seed=7))))
    print("8 rows, 2 ranks vs JAX's 2-device mesh, worst:", _gates(r0, jax_steps["sync8"]))


def test_accumulated_step_equals_jax_mesh(job, jax_steps):
    """accum_steps=2 on 2 ranks: microbatch i is JAX's rows [4i, 4i + 4) of
    the global batch, two a rank, so the step equals JAX's accumulated step
    on the 2-device mesh and the one-process accumulated step, at every
    gate (BN statistics of the second microbatch's rows included)."""
    r0, r1 = ranks_result(job, "accum2")
    assert_trees_equal(r0[0], r1[0])
    print("accum 2, 2 ranks vs JAX's mesh, worst:", _gates(r0, jax_steps["accum2"]))
    single = port_step(MODEL, make_batch(8, seed=7), accum_steps=2)
    print("accum 2, 2 ranks vs one process, worst:", _gates(r0, single))


def test_db_batch_global_step_equals_one_process_and_jax_mesh(job, jax_steps):
    """A db_batch_global model on 2 ranks (rank 1's rows 60 dB quieter): the
    dB reference is the max over both ranks' rows, so the step equals the
    one-process step on the global batch and JAX's mesh step."""
    r0, r1 = ranks_result(job, "db_global")
    assert_trees_equal(r0[0], r1[0])
    single = port_step(MODEL, quiet_batch(), db_batch_global=True)
    print("db_batch_global, 2 ranks vs one process, worst:", _gates(r0, single))
    print("db_batch_global, 2 ranks vs JAX's mesh, worst:", _gates(r0, jax_steps["db_global"]))


def test_per_replica_equals_jax(job, jax_steps):
    """per_replica on 2 ranks equals JAX's bn_mode='per_replica' on the
    2-device mesh, and differs from sync (local statistics)."""
    r0, r1 = ranks_result(job, "per_replica")
    assert_trees_equal(r0[0], r1[0])
    print("per_replica vs JAX, worst:", _gates(r0, jax_steps["per_replica"]))
    sync = ranks_result(job, "sync")[0]
    diff = max(np.abs(a - dict(flat(sync[0]["batch_stats"]))[p]).max()
               for p, a in flat(r0[0]["batch_stats"]))
    assert diff > 1e-6


def test_per_replica_on_one_rank_is_sync():
    """Without a group both modes are the one-device step, bit for bit;
    per_replica with accumulation raises, as JAX's does."""
    batch = make_batch(4, seed=2)
    a, b = port_step(MODEL, batch), port_step(MODEL, batch, bn_mode="per_replica")
    assert a[1] == b[1]
    for k in ("params", "batch_stats", "mu"):
        assert_trees_equal(a[0][k], b[0][k])
    with pytest.raises(NotImplementedError, match="gradient accumulation"):
        make_train_step(accum_steps=2, bn_mode="per_replica")


def test_eval_step_averages_over_ranks(job):
    """The eval step's metrics on 2 ranks are the one-process eval's."""
    from test_torch_port_train import port_state

    outs = [dict(np.load(job / "out" / f"eval_rank{r}.npz")) for r in range(2)]
    assert float(outs[0]["loss"]) == float(outs[1]["loss"])
    state = port_state(MODEL)
    want = make_eval_step()(state, {k: torch.from_numpy(v) for k, v in make_batch(BATCH, seed=7).items()})
    assert abs(float(outs[0]["loss"]) - float(want["loss"])) <= 1e-6 * float(want["loss"])
    assert float(outs[0]["acc"]) == float(want["acc"])


def test_traced_steps_mark_the_exchange(job):
    """Traced on 2 ranks: the rows' gather for the microbatches, the
    gradients' all-reduce and per_replica's running statistics are
    train.exchange spans in the step, beside each microbatch's forward and
    backward."""
    for r in range(2):
        record = json.loads((job / "out" / f"traced_rank{r}.json").read_text())
        assert record["accum2"] == sorted(
            ["train.call<None"] + ["train.exchange<train.call"] * 2 + ["train.forward<train.call"] * 3
            + ["train.backward<train.call"] * 2 + ["train.update<train.call"] * 2)
        assert record["per_replica"] == sorted(
            ["train.call<None", "train.exchange<train.call", "train.forward<train.call",
             "train.backward<train.call", "train.update<train.call"])


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_faults_fail_a_gate(job, jax_steps, fault):
    """Each planted fault fails a gate against the reference it breaks: the
    detached reduction and the averaged variances against JAX's sync step
    (the one-process step too), DDP's broadcast_buffers against JAX's
    per_replica step, each rank's own dB reference against JAX's and the
    one-process db_batch_global step."""
    ours = ranks_result(job, fault)[0]
    if fault == "fault_broadcast_buffers":
        refs = {"per_replica": jax_steps["per_replica"]}
    elif fault == "fault_db_local":
        refs = {"db_global": jax_steps["db_global"],
                "one process": port_step(MODEL, quiet_batch(), db_batch_global=True)}
    else:
        refs = {"sync": jax_steps["sync"], "one process": port_step(MODEL, make_batch(BATCH, seed=7))}
    for what, ref in refs.items():
        with pytest.raises(AssertionError) as caught:
            _gates(ours, ref)
        print(f"{fault} vs {what}: fails {str(caught.value).splitlines()[0][:160]}")


# ---------------------------------------------------------------- train()

@pytest.fixture(scope="module")
def runs(job):
    return [json.loads((job / "out" / f"train_rank{r}.json").read_text()) for r in range(2)]


def test_train_one_run_dir_and_only_the_chief_writes(job, runs):
    """Both ranks work in one run dir; rank 1 opens nothing for writing; the
    run dir holds the one-process run's files; the histories are equal."""
    r0, r1 = runs
    u = r0["uninterrupted"]["model_dir"]
    assert r1["uninterrupted"]["model_dir"] == u
    parent = os.path.dirname(u)
    assert os.listdir(parent) == [os.path.basename(u)]
    assert sorted(os.listdir(u)) == sorted([
        "config.json", "model.json", "history_csvlog.csv", "history_checkpoint.pkl", "history.pkl",
        "model_latest.ckpt", "model_best_valid_accuracy.ckpt", "model_best_valid_loss.ckpt"])
    for name in ("uninterrupted", "preempted", "resumed"):
        assert r1[name]["writes"] == [], (name, r1[name]["writes"])
        assert r0[name]["writes"], name
        assert r0[name]["history"] == r1[name]["history"], name
    with open(os.path.join(u, "config.json")) as f:
        assert json.load(f)["num_devices"] == 2
    assert len(r0["uninterrupted"]["history"]["loss"]) == 2 and r0["uninterrupted"]["step"] == 8


def test_preemption_on_one_rank_stops_both(job, runs):
    """preempt_after_steps on rank 1 alone: both ranks stop at the same step
    (2 polls after rank 1's flag), the chief writes one marker of this
    2-process geometry."""
    r0, r1 = runs
    p0, p1 = r0["preempted"], r1["preempted"]
    assert p0["preempted"] and p1["preempted"] and p0["step"] == p1["step"] == 3
    # The resume removed the marker from the run dir; the chief copied the
    # dir before it.
    with open(job / "out" / "p_copy" / "preempt.json") as f:
        marker = json.load(f)
    assert marker["process_count"] == 2 and marker["per_process_batch_size"] == 4
    assert (marker["epoch"], marker["steps_done_in_epoch"]) == (0, 3)


def test_exact_step_resume_on_two_ranks_is_bit_for_bit(job, runs):
    r0, r1 = runs
    assert not r0["resumed"]["preempted"] and r0["resumed"]["step"] == r1["resumed"]["step"] == 8
    p_dir = r0["preempted"]["model_dir"]
    assert not os.path.exists(os.path.join(p_dir, "preempt.json"))
    with open(os.path.join(r0["uninterrupted"]["model_dir"], "model_latest.ckpt"), "rb") as a, \
            open(os.path.join(p_dir, "model_latest.ckpt"), "rb") as b:
        assert a.read() == b.read(), "the resumed 2-rank run differs from the uninterrupted one"


def test_resume_on_another_process_count_is_refused(job, runs, tmp_path):
    copy = str(tmp_path / "p")
    shutil.copytree(job / "out" / "p_copy", copy)
    with pytest.raises(ValueError, match="2-process run; resuming on 1 processes"):
        train(str(job / "train_h5"), str(job / "valid_h5"), "unused", continue_model_dir=copy,
              num_epochs=2, train_epoch_size=4, validation_epoch_size=1, train_batch_size=8,
              validation_batch_size=8, model_type=MODEL, random_state=11, disable_logging=True,
              device="cpu")


def test_two_rank_checkpoint_restores_in_one_process_and_jax(job, runs):
    """The 2-rank run's model_latest.ckpt restores in one process (the
    port's load_state) and in JAX, to the same state."""
    from test_torch_port_train import port_state

    path = os.path.join(runs[0]["uninterrupted"]["model_dir"], "model_latest.ckpt")
    state = port_state(MODEL)
    checkpoints.load_state(path, state)
    assert state.step == 8
    ours = checkpoints.state_tree(state)
    theirs = jax.tree.map(np.asarray, jax_ckpt.load_state(path, jax_template()))
    assert int(theirs.step) == 8
    assert_trees_equal(ours["params"], theirs.params)
    assert_trees_equal(ours["batch_stats"], theirs.batch_stats)
    assert_trees_equal(ours["opt_state"]["0"]["mu"], theirs.opt_state[0].mu)


def test_two_rank_directory_snapshot_restores_in_one_process(job):
    """The sync step's state, saved by both ranks as one directory snapshot
    (``training/dir_checkpoints.py``), restores in one process to the
    ``.ckpt`` that the same job wrote of it, leaf for leaf."""
    from l3embedding_torch.training.dir_checkpoints import load_state_dir
    from test_torch_port_train import port_state

    files = sorted(os.listdir(job / "out" / "sync_dir"))
    assert files[0] == ".metadata" and all(f.endswith(".distcp") for f in files[1:])
    state = port_state(MODEL)
    load_state_dir(str(job / "out" / "sync_dir"), state)
    assert state.step == 1
    assert_trees_equal(checkpoints.state_tree(state), checkpoints.read_tree(str(job / "out" / "sync_rank0.ckpt")))
