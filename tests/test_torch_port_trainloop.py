"""The port's training loop, data pipeline, checkpoints and train CLI
against the JAX package on the CPU, on tiny_L3 and small h5 corpora in the
format of ``02_generate_samples.py``.

  * ``.ckpt`` files interoperate exactly: a port-written state restores
    through JAX's ``load_state`` / ``load_variables`` bit for bit, a
    JAX-written one through the port's, and a JAX file read into the port
    and written again comes out byte for byte the same.
  * ``data_generator`` yields JAX's batches, in JAX's order, with the same
    ``start_batch_idx`` fast-forward.
  * ``train()`` from one JAX-written step-0 ``model_latest.ckpt`` (placed in
    two copies of a ``continue_model_dir``) gives JAX ``train()``'s history
    rows within 3e-4 relative on the losses (measured 5.6e-5 against JAX on
    its 8-device CPU mesh, printed; Adam's steps on the gradients that are
    zero but for rounding differ, and so do the BN reductions) and one
    validation sample (1/16) on the accuracies (measured equal), and the
    same files.
  * a ``preempt_after_steps`` run resumed through ``continue_model_dir`` ends
    bit for bit where the uninterrupted run ends; stale, truncated and
    orphaned markers fall back to the epoch boundary, a marker of another
    geometry raises.
"""

import csv
import json
import os
import pickle
import shutil
import subprocess
import sys

import h5py
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from l3embedding_tpu.embed.extract import EmbeddingExtractor as JaxExtractor
from l3embedding_tpu.models import build_model as jax_build_model
from l3embedding_tpu.training import checkpoints as jax_ckpt
from l3embedding_tpu.training import data as jax_data
from l3embedding_tpu.training.loop import train as jax_train
from l3embedding_tpu.training.state import create_train_state as jax_create_train_state
from l3embedding_torch.embed.extract import EmbeddingExtractor
from l3embedding_torch.models.registry import build_model
from l3embedding_torch.training import checkpoints, data
from l3embedding_torch.training.__main__ import main as cli_main
from l3embedding_torch.training.loop import PREEMPT_FILE, train
from l3embedding_torch.training.state import create_train_state
from l3embedding_torch.training.steps import make_train_step
from torch_port_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ARGS = dict(
    num_epochs=2,
    train_epoch_size=3,
    validation_epoch_size=2,
    train_batch_size=8,
    validation_batch_size=8,
    model_type="tiny_L3",
    random_state=11,
    learning_rate=1e-4,
    checkpoint_interval=2,
    disable_logging=True,
)


def make_corpus(path, num_blobs, blob_size, seed):
    """h5 batch files as 02_generate_samples.py writes them."""
    rng = np.random.RandomState(seed)
    os.makedirs(path, exist_ok=True)
    for i in range(num_blobs):
        labels = rng.randint(0, 2, size=blob_size)
        with h5py.File(os.path.join(path, f"blob_{i}.h5"), "w") as f:
            f.create_dataset("audio", data=(rng.randn(blob_size, 1, 48000) * 3000).astype(np.int16))
            f.create_dataset(
                "video", data=rng.randint(0, 256, size=(blob_size, 224, 224, 3)).astype(np.uint8))
            f.create_dataset(
                "label", data=np.stack([labels, 1 - labels], axis=1).astype(np.float32))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("avc")
    make_corpus(str(root / "train_h5"), 3, 24, 0)
    make_corpus(str(root / "valid_h5"), 1, 16, 1)
    return str(root / "train_h5"), str(root / "valid_h5")


def flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def assert_trees_equal(a, b):
    fa, fb = dict(flat(a)), dict(flat(b))
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg="/".join(k))


def jax_template(model_type="tiny_L3"):
    spec = jax_build_model(model_type)
    return jax_create_train_state(
        spec.module(), jax.random.PRNGKey(0), spec.video_input_shape, spec.audio_input_shape, 1e-4
    )


def jax_payload(state):
    return jax.tree.map(np.asarray, {
        "step": state.step, "params": state.params,
        "batch_stats": state.batch_stats, "opt_state": state.opt_state,
    })


def trained_port_state(steps=2):
    """A tiny_L3 port state after `steps` steps (Adam state not zero)."""
    state = create_train_state(build_model("tiny_L3"), torch.Generator().manual_seed(3), 1e-3, device="cpu")
    step = make_train_step()
    rng = np.random.RandomState(2)
    for _ in range(steps):
        lab = rng.randint(0, 2, 4)
        batch = {
            "video": torch.from_numpy(rng.randint(0, 256, (4, 224, 224, 3)).astype(np.uint8)),
            "audio": torch.from_numpy((rng.randn(4, 1, 48000) * 3000).astype(np.int16)),
            "label": torch.from_numpy(np.stack([lab, 1 - lab], 1).astype(np.float32)),
        }
        state, _ = step(state, batch)
    return state


# ---------------------------------------------------------------- checkpoints

def test_port_ckpt_restores_in_jax(tmp_path):
    """A port-written state → JAX load_state and load_variables, exact."""
    state = trained_port_state()
    path = str(tmp_path / "port.ckpt")
    checkpoints.save_state(path, state)
    want = checkpoints.state_tree(state)
    restored = jax_ckpt.load_state(path, jax_template())
    got = jax_payload(restored)
    assert int(got["step"]) == 2 and got["step"].dtype == np.int32
    assert int(got["opt_state"][0].count) == 2
    for k in ("params", "batch_stats"):
        assert_trees_equal(got[k], want[k])
    assert_trees_equal(got["opt_state"][0].mu, want["opt_state"]["0"]["mu"])
    assert_trees_equal(got["opt_state"][0].nu, want["opt_state"]["0"]["nu"])
    variables = jax_ckpt.load_variables(path, {"params": got["params"], "batch_stats": got["batch_stats"]})
    assert_trees_equal(jax.tree.map(np.asarray, variables["params"]), want["params"])


def test_jax_ckpt_restores_in_port_byte_for_byte(tmp_path):
    """A JAX-written state (after one step, so Adam's moments are not zero)
    → the port's load_state; written again by the port, the file is the
    same bytes."""
    from l3embedding_tpu.training.steps import make_train_step as jax_make_train_step

    spec = jax_build_model("tiny_L3")
    jstate = jax_template()
    rng = np.random.RandomState(4)
    lab = rng.randint(0, 2, 2)
    batch = {"video": rng.randint(0, 256, (2, 224, 224, 3)).astype(np.uint8),
             "audio": (rng.randn(2, 1, 48000) * 3000).astype(np.int16),
             "label": np.stack([lab, 1 - lab], 1).astype(np.float32)}
    jstate, _ = jax_make_train_step(spec.module(), donate=False)(jstate, batch)
    a = str(tmp_path / "jax.ckpt")
    jax_ckpt.save_state(a, jstate)
    state = create_train_state(build_model("tiny_L3"), torch.Generator().manual_seed(0), 1e-4, device="cpu")
    checkpoints.load_state(a, state)
    assert state.step == 1
    assert all(float(s["step"]) == 1.0 for s in state.optimizer.state.values())
    b = str(tmp_path / "port.ckpt")
    checkpoints.save_state(b, state)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    with open(a, "rb") as fa:
        assert checkpoints.to_bytes(checkpoints.read_tree(a)) == fa.read()


def test_step0_state_layout_matches_optax(tmp_path):
    """Before any step torch holds no Adam state: the port writes optax's
    init (zeros, count 0), with JAX's tree and dtypes."""
    state = create_train_state(build_model("tiny_L3"), torch.Generator().manual_seed(0), 1e-4, device="cpu")
    tree = checkpoints.state_tree(state)
    ref = jax_payload(jax_template())
    assert np.asarray(tree["step"]).dtype == np.int32 and int(tree["step"]) == 0
    assert tree["opt_state"]["1"] == {}
    assert np.asarray(tree["opt_state"]["0"]["count"]).dtype == np.int32
    ref_mu = dict(flat(ref["opt_state"][0].mu))
    for path, mu in flat(tree["opt_state"]["0"]["mu"]):
        assert mu.shape == ref_mu[path].shape and not mu.any(), path
    assert {p for p, _ in flat(tree["params"])} == {p for p, _ in flat(ref["params"])}


def test_async_writer_bytes_equal_sync_and_surfaces_errors(tmp_path):
    state = trained_port_state(1)
    checkpoints.save_state(str(tmp_path / "sync.ckpt"), state)
    with checkpoints.AsyncCheckpointWriter() as w:
        w.save(str(tmp_path / "async.ckpt"), state)
        # The snapshot was taken before save() returned: a later in-place
        # update does not reach the file.
        with torch.no_grad():
            next(state.model.parameters()).add_(1.0)
        w.flush()
    assert (tmp_path / "sync.ckpt").read_bytes() == (tmp_path / "async.ckpt").read_bytes()
    w = checkpoints.AsyncCheckpointWriter()
    w.save(str(tmp_path / "missing_dir" / "x.ckpt"), state)
    with pytest.raises(FileNotFoundError):
        w.flush()
    w.close()
    with pytest.raises(RuntimeError, match="closed"):
        w.save(str(tmp_path / "y.ckpt"), state)


def test_extractor_rows_from_port_trained_ckpt(tmp_path):
    """A port-trained .ckpt gives the same embedding rows in JAX's
    EmbeddingExtractor and the port's (f32 gate)."""
    path = str(tmp_path / "trained.ckpt")
    checkpoints.save_state(path, trained_port_state(3))
    windows = (np.random.RandomState(9).randn(3, 48000) * 0.2).astype(np.float32)
    ours = EmbeddingExtractor(path, "tiny_L3", "original", device="cpu").embed_windows(windows)
    theirs = JaxExtractor(path, "tiny_L3", "original").embed_windows(windows)
    ours, theirs = np.asarray(ours, np.float64), np.asarray(theirs, np.float64)
    assert ours.shape == theirs.shape == (3, 350)
    for a, b in zip(ours, theirs):
        assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) >= 0.99999


# ---------------------------------------------------------------- data

@pytest.mark.parametrize("start", [None, 0, 5])
def test_data_generator_matches_jax(corpus, start):
    train_dir, _ = corpus
    ours = data.data_generator(train_dir, batch_size=10, random_state=7, start_batch_idx=start)
    theirs = jax_data.data_generator(train_dir, batch_size=10, random_state=7, start_batch_idx=start)
    for _ in range(9):  # past two passes over 72 samples
        a, b = next(ours), next(theirs)
        assert list(a) == list(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_single_epoch_generator_restarts_like_jax(corpus):
    _, valid_dir = corpus
    ours = data.single_epoch_data_generator(valid_dir, 2, batch_size=6, random_state=3)
    theirs = jax_data.single_epoch_data_generator(valid_dir, 2, batch_size=6, random_state=3)
    for _ in range(5):
        a, b = next(ours), next(theirs)
        np.testing.assert_array_equal(a["audio"], b["audio"])
        np.testing.assert_array_equal(a["label"], b["label"])


def test_log_timers(caplog):
    """LogTimer logs a block's wall time; StepTimer returns what it observes
    (on the card it waits for the devices that hold it first)."""
    import logging

    from l3embedding_torch.utils.log import LogTimer, StepTimer

    logger = logging.getLogger("l3embedding_torch.test")
    with caplog.at_level(logging.DEBUG, logger="l3embedding_torch.test"):
        with LogTimer(logger, "block") as t:
            pass
    assert t.elapsed >= 0 and "block took" in caplog.text
    out = {"loss": torch.zeros(()), "x": [torch.ones(2)]}
    with StepTimer() as st:
        assert st.observe(out) is out
    assert st.elapsed >= 0


def test_to_device_keeps_storage_dtypes():
    b = {"video": np.zeros((2, 4, 4, 3), np.uint8), "audio": np.zeros((2, 1, 8), np.int16)}
    t = data.to_device(b, "cpu")
    assert t["video"].dtype == torch.uint8 and t["audio"].dtype == torch.int16


# ---------------------------------------------------------------- train()

@pytest.fixture(scope="module")
def twin_runs(corpus, tmp_path_factory):
    """JAX train() and the port's from one JAX-written step-0 checkpoint."""
    train_dir, valid_dir = corpus
    root = tmp_path_factory.mktemp("twins")
    dirs = {}
    for name in ("jax", "port"):
        dirs[name] = str(root / name)
        os.makedirs(dirs[name])
    spec = jax_build_model("tiny_L3")
    state0 = jax_create_train_state(
        spec.module(), jax.random.PRNGKey(11), spec.video_input_shape, spec.audio_input_shape, 1e-4)
    jax_ckpt.save_state(os.path.join(dirs["jax"], "model_latest.ckpt"), state0)
    shutil.copy(os.path.join(dirs["jax"], "model_latest.ckpt"), dirs["port"])
    _, h_jax = jax_train(train_dir, valid_dir, "unused", continue_model_dir=dirs["jax"], **ARGS)
    _, h_port = train(train_dir, valid_dir, "unused", continue_model_dir=dirs["port"],
                      device="cpu", **ARGS)
    return dirs, h_jax, h_port


def _rows(model_dir):
    with open(os.path.join(model_dir, "history_csvlog.csv")) as f:
        return list(csv.DictReader(f))


def test_train_history_matches_jax(twin_runs):
    dirs, h_jax, h_port = twin_runs
    rows_j, rows_p = _rows(dirs["jax"]), _rows(dirs["port"])
    assert [r["epoch"] for r in rows_p] == [r["epoch"] for r in rows_j] == ["0", "1"]
    rel = max(abs(float(rp[k]) / float(rj[k]) - 1) for rj, rp in zip(rows_j, rows_p)
              for k in ("loss", "val_loss"))
    print(f"train() history vs JAX train(): losses within {rel:.2e} relative")
    for rj, rp in zip(rows_j, rows_p):
        for k in ("loss", "val_loss"):
            assert abs(float(rp[k]) - float(rj[k])) <= 3e-4 * abs(float(rj[k])), (k, rp, rj)
        for k in ("acc", "val_acc"):
            assert abs(float(rp[k]) - float(rj[k])) <= 1 / 16, (k, rp, rj)
    for k in ("loss", "val_loss", "acc", "val_acc"):
        assert len(h_port[k]) == len(h_jax[k]) == 2


def test_train_writes_jax_files(twin_runs):
    dirs, _, h_port = twin_runs
    assert sorted(os.listdir(dirs["port"])) == sorted(os.listdir(dirs["jax"]))
    with open(os.path.join(dirs["port"], "history.pkl"), "rb") as f:
        saved = pickle.load(f)
    assert saved["val_acc"] == h_port["val_acc"] and len(saved["batch_times"]) == 6
    assert len(saved["data_wait_times"]) == 6 and len(saved["checkpoint_times"]) == 2
    with open(os.path.join(dirs["port"], "config.json")) as f:
        config = json.load(f)
    assert config["backend"] == "torch-cpu" and config["model_type"] == "tiny_L3"
    with open(os.path.join(dirs["port"], "model.json")) as f:
        assert json.load(f)["audio_input_shape"] == [1, 48000]
    # The trained state restores in JAX.
    restored = jax_ckpt.load_state(os.path.join(dirs["port"], "model_latest.ckpt"), jax_template())
    assert int(restored.step) == 6


def test_train_new_run_dir_and_resume(corpus, tmp_path):
    """A fresh run makes <out>/embedding/<subset>/<model>/<timestamp>; a
    resume through continue_model_dir adds one epoch's row."""
    train_dir, valid_dir = corpus
    model_dir, _ = train(train_dir, valid_dir, str(tmp_path), device="cpu", gsheet_id="sheet", **ARGS)
    assert os.path.dirname(model_dir) == os.path.join(str(tmp_path), "embedding", "train", "tiny_L3")
    # gsheet_id tracks the run locally as JSONL: the config row, then one update an epoch.
    with open(os.path.join(model_dir, "experiments.jsonl")) as f:
        events = [json.loads(line)["event"] for line in f]
    assert events == ["upsert", "update", "update"]
    _, hist = train(train_dir, valid_dir, "unused", continue_model_dir=model_dir,
                    device="cpu", **dict(ARGS, num_epochs=3))
    assert [int(r["epoch"]) for r in _rows(model_dir)] == [0, 1, 2]
    assert len(hist["loss"]) == 1


@pytest.fixture(scope="module")
def finished_run_dir(corpus, tmp_path_factory):
    """One uninterrupted 2-epoch run of ARGS, shared by the tests that
    compare with it or resume a copy of it."""
    train_dir, valid_dir = corpus
    model_dir, _ = train(train_dir, valid_dir, str(tmp_path_factory.mktemp("finished")), device="cpu", **ARGS)
    return model_dir


def test_preempt_resume_matches_uninterrupted(corpus, finished_run_dir, tmp_path):
    """A run preempted after 4 steps and resumed ends bit for bit where the
    shared uninterrupted run ends (checkpoint_interval writes periodic files
    only, so the two runs' model_latest.ckpt compare at either setting)."""
    train_dir, valid_dir = corpus
    args = dict(ARGS, checkpoint_interval=10)
    dir_a = finished_run_dir
    dir_b, _ = train(train_dir, valid_dir, str(tmp_path / "b"), device="cpu",
                     preempt_after_steps=4, **args)
    with open(os.path.join(dir_b, PREEMPT_FILE)) as f:
        info = json.load(f)
    assert (info["epoch"], info["steps_done_in_epoch"], info["global_batch_idx"]) == (1, 1, 4)
    assert info["checkpoint"] == "model_preempt.ckpt"
    latest_b = os.path.join(dir_b, "model_latest.ckpt")
    with open(latest_b, "rb") as fl, open(os.path.join(dir_b, "model_preempt.ckpt"), "rb") as fp:
        assert fl.read() != fp.read()
    _, hist = train(train_dir, valid_dir, "unused", continue_model_dir=dir_b, device="cpu", **args)
    assert not os.path.exists(os.path.join(dir_b, PREEMPT_FILE))
    assert not os.path.exists(os.path.join(dir_b, "model_preempt.ckpt"))
    assert len(hist["loss"]) == 1
    with open(os.path.join(dir_a, "model_latest.ckpt"), "rb") as fa, open(latest_b, "rb") as fb:
        assert fa.read() == fb.read(), "resumed state differs from the uninterrupted run"


@pytest.fixture
def finished_run(finished_run_dir, tmp_path):
    """A copy of the shared finished run, for one test to resume or break."""
    model_dir = str(tmp_path / "finished")
    shutil.copytree(finished_run_dir, model_dir)
    return model_dir


@pytest.mark.parametrize("marker", [
    {"epoch": 0, "steps_done_in_epoch": 2, "global_batch_idx": 2, "process_count": 1},  # stale
    '{"epoch": 1, "steps_do',  # truncated
    {"epoch": 2, "steps_done_in_epoch": 1, "checkpoint": "gone.ckpt"},  # missing snapshot
])
def test_bad_preempt_marker_falls_back_to_epoch_boundary(corpus, finished_run, marker):
    train_dir, valid_dir = corpus
    path = os.path.join(finished_run, PREEMPT_FILE)
    with open(path, "w") as f:
        f.write(marker if isinstance(marker, str) else json.dumps(marker))
    _, hist = train(train_dir, valid_dir, "unused", continue_model_dir=finished_run,
                    device="cpu", **dict(ARGS, num_epochs=3))
    assert not os.path.exists(path)
    rows = _rows(finished_run)
    assert [int(r["epoch"]) for r in rows] == [0, 1, 2]
    assert len(hist["loss"]) == 1 and np.isfinite(float(rows[2]["acc"]))


@pytest.fixture(scope="module")
def preempted_run_dir(corpus, tmp_path_factory):
    """One run preempted after 2 steps, shared: each test breaks a copy."""
    train_dir, valid_dir = corpus
    model_dir, _ = train(train_dir, valid_dir, str(tmp_path_factory.mktemp("preempted")), device="cpu",
                         preempt_after_steps=2, **ARGS)
    return model_dir


@pytest.mark.parametrize("field,value,match", [
    ("per_process_batch_size", 4, "batch size"),
    ("train_epoch_size", 7, "train_epoch_size"),
    ("process_count", 2, "2-process"),
])
def test_preempt_geometry_mismatch_rejected(corpus, preempted_run_dir, tmp_path, field, value, match):
    train_dir, valid_dir = corpus
    model_dir = str(tmp_path / "preempted")
    shutil.copytree(preempted_run_dir, model_dir)
    path = os.path.join(model_dir, PREEMPT_FILE)
    with open(path) as f:
        info = json.load(f)
    info[field] = value
    with open(path, "w") as f:
        json.dump(info, f)
    with pytest.raises(ValueError, match=match):
        train(train_dir, valid_dir, "unused", continue_model_dir=model_dir, device="cpu", **ARGS)


def test_profile_steps_writes_a_trace(corpus, tmp_path):
    train_dir, valid_dir = corpus
    model_dir, _ = train(train_dir, valid_dir, str(tmp_path), device="cpu", profile_steps=2,
                         **dict(ARGS, num_epochs=1))
    assert os.path.getsize(os.path.join(model_dir, "profile", "trace.json")) > 0


# ---------------------------------------------------------------- CLI

def test_cli_trains_on_cpu(corpus, tmp_path):
    train_dir, valid_dir = corpus
    rc = cli_main(["--device", "cpu", "-mt", "tiny_L3", "-e", "1", "-tes", "2", "-ves", "1",
                   "-tbs", "8", "-vbs", "8", "-nl", "--sync-checkpoints",
                   train_dir, valid_dir, str(tmp_path)])
    assert rc == 0
    (run,) = os.listdir(tmp_path / "embedding" / "train" / "tiny_L3")
    files = os.listdir(tmp_path / "embedding" / "train" / "tiny_L3" / run)
    assert "model_best_valid_loss.ckpt" in files and "history_csvlog.csv" in files


def test_cli_module_entry_point():
    out = subprocess.run([sys.executable, "-m", "l3embedding_torch.training", "--help"],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "--device" in out.stdout and "--continue-model-dir" in out.stdout
