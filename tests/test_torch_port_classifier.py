"""The port's downstream classifier (``l3embedding_torch/classifier``,
``cli/train_classifier.py``) against the JAX package's: the classifier
cases of ``tests/test_downstream.py`` on its ``make_features_dir`` fixture,
each against JAX's ``train()`` on the same features (svm and rf are the
same sklearn code: equal results; mlp: the same files and keys), the MLP
step for step from JAX's initial parameters, ``model.pkl`` and
``results.pkl`` across the packages, and the CLI's flags."""

import copy
import importlib.util
import json
import os
import pickle
import sys

import numpy as np
import pytest
import torch

import jax

from l3embedding_tpu.classifier import metrics as jax_metrics
from l3embedding_tpu.classifier import mlp as jax_mlp
from l3embedding_tpu.classifier import train as jax_train
from l3embedding_torch.classifier import metrics, mlp
from l3embedding_torch.classifier import train as port_train
from l3embedding_torch.cli import train_classifier as cli
from l3embedding_torch.compat.from_jax import mlp_from_jax
from l3embedding_torch.compat.to_jax import mlp_to_jax
from l3embedding_torch.data.usc.features import preprocess_split_data
from l3embedding_torch.data.usc.folds import get_split
from test_downstream import make_features_dir
from torch_port_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def features_dir(tmp_path_factory):
    return make_features_dir(str(tmp_path_factory.mktemp("ds")))


def test_metrics_equal_jax():
    y = [0, 0, 1, 1, 2, 2]
    pred = [0, 1, 1, 1, 2, 0]
    m = metrics.compute_metrics(y, pred, num_classes=3)
    assert m["accuracy"] == pytest.approx(4 / 6)
    assert m["class_accuracy"][1] == pytest.approx(1.0)
    j = jax_metrics.compute_metrics(y, pred, num_classes=4)
    np.testing.assert_equal(metrics.compute_metrics(y, pred, num_classes=4), j)
    folds = [{"accuracy": 0.5}, {"accuracy": 0.7}, {"accuracy": 0.9}]
    agg = metrics.aggregate_metrics(folds)
    assert agg["accuracy"]["mean"] == pytest.approx(0.7)
    assert agg["accuracy"]["max"] == pytest.approx(0.9)
    assert agg == jax_metrics.aggregate_metrics(folds)
    assert metrics.collapse_metrics(folds) == jax_metrics.collapse_metrics(folds)


def key_tree(obj):
    """The nested key structure of a results dict (values left out)."""
    if isinstance(obj, dict):
        return {str(k): key_tree(v) for k, v in obj.items()}
    return type(obj).__name__ if isinstance(obj, (list, dict)) else None


MLP_ARGS = dict(num_epochs=8, learning_rate=1e-3)


def _both(features_dir, tmp_path, fold_num=1, **kw):
    """train() of each package on one features dir, the global numpy state
    seeded alike before each (the preprocessing's shuffle draws from it)."""
    out = {}
    for name, fn, extra in (("jax", jax_train.train, {}), ("port", port_train.train, {"device": "cpu"})):
        np.random.seed(0)
        model_dir, results = fn(features_dir, str(tmp_path / name), fold_num=fold_num, **kw, **extra)
        with open(os.path.join(model_dir, "results.pkl"), "rb") as f:
            saved = pickle.load(f)
        with open(os.path.join(model_dir, "config.json")) as f:
            config = json.load(f)
        out[name] = dict(model_dir=model_dir, results=results, saved=saved, config=config,
                         files=sorted(os.listdir(model_dir)))
    return out["jax"], out["port"]


@pytest.mark.parametrize("model_type", ["svm", "rf", "mlp"])
def test_classifier_end_to_end_as_jax(features_dir, tmp_path, model_type):
    """train() writes JAX's run directory: the same files, config.json
    (but the paths), results.pkl keys, and for svm and rf (the same
    sklearn code) the same results; the synthetic classes are separable."""
    kw = dict(model_type=model_type, feature_mode="framewise", random_state=5)
    if model_type == "mlp":
        kw.update(MLP_ARGS)
    theirs, ours = _both(features_dir, tmp_path, **kw)
    assert ours["files"] == theirs["files"]
    rel = os.path.relpath(ours["model_dir"], str(tmp_path / "port"))
    assert os.path.dirname(rel) == os.path.dirname(os.path.relpath(theirs["model_dir"], str(tmp_path / "jax")))
    drop = ("model_dir", "output_dir")
    assert ({k: v for k, v in ours["config"].items() if k not in drop}
            == {k: v for k, v in theirs["config"].items() if k not in drop})
    assert key_tree(ours["saved"]) == key_tree(theirs["saved"])
    assert ours["saved"]["test"]["accuracy"] > 0.9
    assert "average_class_accuracy" in ours["saved"]["test"]
    if model_type != "mlp":
        np.testing.assert_equal(ours["saved"], theirs["saved"])


def test_classifier_stats_mode_as_jax(features_dir, tmp_path):
    theirs, ours = _both(features_dir, tmp_path, fold_num=2, model_type="svm", feature_mode="stats",
                         random_state=5)
    assert ours["results"]["test"]["accuracy"] >= 0.8
    np.testing.assert_equal(ours["saved"], theirs["saved"])


@pytest.fixture(scope="module")
def split(features_dir):
    """Fold 1 held out, preprocessed once (framewise, standardised)."""
    train, valid, test = get_split(features_dir, 0, "us8k")
    np.random.seed(0)
    preprocess_split_data(train, valid, test)
    return train, valid, test


def _jax_init(generator, input_dim, num_classes=10, hidden=(512, 128)):
    """JAX's initial parameters for the generator's seed, as the port's MLP."""
    key = jax.random.PRNGKey(int(generator.initial_seed()))
    return mlp_from_jax(jax_mlp.init_mlp_params(key, input_dim, num_classes, hidden))


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return (a @ b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30)


# Measured on the CPU, 5 epochs of 25 steps at lr 1e-4, from JAX's initial
# parameters: losses within 5.3e-5 relative, accuracies equal, every layer's
# parameters at cosine >= 0.99999996 and the file-level predictions equal.
# After 1 epoch every parameter lies within 1.2e-5 of JAX's; Adam divides
# each gradient by its own running scale, so the rounding of the
# near-zero gradients of units that barely fire grows from step to step
# (lr 1e-3, 60 epochs: the last layer's kernel at cosine 0.984 while both
# packages classify every test file alike).
PARITY_LOSS_REL = 5e-4
PARITY_COS = 0.99999


def test_mlp_matches_jax_step_for_step(split, tmp_path, monkeypatch):
    """Both packages' train_mlp on the same split, the port from JAX's
    initial parameters: histories, best epoch, per-layer parameters and
    file-level predictions."""
    monkeypatch.setattr(mlp, "init_mlp_params", _jax_init)
    kw = dict(num_epochs=5, learning_rate=1e-4, random_state=5, batch_size=64, patience=20)
    os.makedirs(tmp_path / "jax")
    os.makedirs(tmp_path / "port")
    theirs = jax_train.train_mlp(*copy.deepcopy(split), str(tmp_path / "jax"), **kw)
    ours = port_train.train_mlp(*copy.deepcopy(split), str(tmp_path / "port"), device="cpu", **kw)
    # One row's flip moves an epoch's accuracy by about 1/rows.
    for i, rows in ((1, len(split[0]["labels"])), (2, len(split[1]["labels"]))):
        j, p = theirs[i], ours[i]
        assert len(p["loss_history"]) == len(j["loss_history"]) == 5
        np.testing.assert_allclose(p["loss_history"], j["loss_history"], rtol=PARITY_LOSS_REL)
        np.testing.assert_allclose(p["accuracy_history"], j["accuracy_history"], rtol=0, atol=1 / rows)
    with open(tmp_path / "port" / "history_checkpoint.pkl", "rb") as f:
        hist = pickle.load(f)
    assert hist["loss"] == ours[1]["loss_history"] and hist["val_loss"] == ours[2]["loss_history"]
    best = int(np.argmin(theirs[2]["loss_history"]))
    assert best == int(np.argmin(ours[2]["loss_history"]))
    assert (theirs[2]["loss"], ours[2]["loss"]) == (theirs[2]["loss_history"][best], ours[2]["loss_history"][best])
    for layer_j, layer_p in zip(theirs[0], mlp_to_jax(ours[0])):
        for k in ("w", "b"):
            assert _cos(layer_p[k], layer_j[k]) >= PARITY_COS, k
    assert ours[3]["accuracy"] == theirs[3]["accuracy"]
    test = split[2]
    preds_j = port_train._file_level_predictions(jax_mlp.predict_proba(theirs[0], test["features"]),
                                                 test["file_idxs"])
    preds_p = port_train._file_level_predictions(mlp.predict_proba(ours[0], test["features"]), test["file_idxs"])
    np.testing.assert_array_equal(preds_p, preds_j)


def test_mlp_early_stopping_restores_the_best_epoch(split):
    """With patience 1 at a high learning rate the run stops early, and the
    returned MLP holds the best epoch's weights (a copy, not the last
    epoch's): its validation loss is the history's at best_epoch."""
    train, valid, _ = split
    model, hist = mlp.train_mlp_torch(train["features"], train["labels"], valid["features"], valid["labels"],
                                      num_epochs=30, patience=1, learning_rate=0.05, random_state=3,
                                      device="cpu")
    n = len(hist["valid_loss"])
    best = hist["best_epoch"]
    assert n < 30 and best == int(np.argmin(hist["valid_loss"])) and best < n - 1
    assert n == best + 3  # stops when since_best > patience
    yv = torch.from_numpy(np.eye(10, dtype=np.float32)[valid["labels"]])
    with torch.no_grad():
        loss, _ = mlp._loss_fn(model, torch.from_numpy(valid["features"].astype(np.float32)), yv, 1e-5)
    assert float(loss) == pytest.approx(hist["valid_loss"][best], rel=1e-6)
    assert float(loss) != pytest.approx(hist["valid_loss"][-1], rel=1e-6)


def test_mlp_valid_split_and_batches_as_jax(split, monkeypatch):
    """Without a validation set both packages split the same rows off with
    the same RandomState: one epoch from JAX's initial parameters gives
    JAX's history."""
    train = split[0]
    X, y = train["features"][:640], train["labels"][:640]
    monkeypatch.setattr(mlp, "init_mlp_params", _jax_init)
    _, h_p = mlp.train_mlp_torch(X, y, num_epochs=1, random_state=9, device="cpu")
    _, h_j = jax_mlp.train_mlp_jax(X, y, num_epochs=1, random_state=9)
    for k in ("train_loss", "valid_loss"):
        np.testing.assert_allclose(h_p[k], h_j[k], rtol=1e-5)
    assert h_p["valid_acc"] == h_j["valid_acc"] and h_p["best_epoch"] == h_j["best_epoch"] == 0


def test_model_and_results_pickles_cross_load(split, tmp_path):
    """model.pkl of either package predicts in the other: JAX's through
    mlp_from_jax, the port's through JAX's predict_proba; results.pkl
    dicts read by both share their keys."""
    kw = dict(num_epochs=2, random_state=4)
    for name, fn, extra in (("jax", jax_train.train_mlp, {}), ("port", port_train.train_mlp, {"device": "cpu"})):
        os.makedirs(tmp_path / name)
        fn(*copy.deepcopy(split), str(tmp_path / name), **kw, **extra)
    feats = split[2]["features"][:300]
    with open(tmp_path / "jax" / "model.pkl", "rb") as f:
        params_j = pickle.load(f)["params"]
    with open(tmp_path / "port" / "model.pkl", "rb") as f:
        params_p = pickle.load(f)["params"]
    assert [sorted(layer) for layer in params_p] == [sorted(layer) for layer in params_j]
    assert [layer["w"].shape for layer in params_p] == [np.asarray(layer["w"]).shape for layer in params_j]
    assert all(isinstance(layer["w"], np.ndarray) and layer["w"].dtype == np.float32 for layer in params_p)
    np.testing.assert_allclose(mlp.predict_proba(mlp_from_jax(params_j), feats),
                               jax_mlp.predict_proba(params_j, feats), rtol=0, atol=1e-5)
    np.testing.assert_allclose(jax_mlp.predict_proba(params_p, feats),
                               mlp.predict_proba(mlp_from_jax(params_p), feats), rtol=0, atol=1e-5)


def _root_06_arguments(argv):
    spec = importlib.util.spec_from_file_location("root_06", os.path.join(REPO, "06_train_classifier.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    old = sys.argv
    sys.argv = ["06_train_classifier.py"] + argv
    try:
        return mod.parse_arguments()
    finally:
        sys.argv = old


def test_cli_parses_as_06(features_dir, tmp_path):
    """Every flag of 06_train_classifier.py parses to the same dests; the
    port adds --device. Then the CLI trains an svm end to end."""
    argv = ["-e", "7", "-tbs", "32", "-eap", "3", "-ps", "-psnv", "-psvr", "0.2", "-pstwv", "-lr", "0.001",
            "-wd", "0.0001", "-npf", "2.5", "-sct", "0.001", "-smi", "50", "-skt", "linear", "-rfne", "11",
            "-gsid", "sheet", "-gdan", "app", "-r", "7", "-v", "-fm", "stats", "-mt", "rf", "-no",
            "-nocs", "5", "-mm", "feats/features/us8k", "out", "3"]
    ours = cli.parse_arguments(argv + ["--device", "cpu"])
    assert ours.pop("device") == "cpu"
    assert ours == _root_06_arguments(argv)
    assert cli.parse_arguments(["f", "o", "1"]) == {**_root_06_arguments(["f", "o", "1"]), "device": "cuda"}
    np.random.seed(0)
    assert cli.main(["-mt", "svm", "-r", "5", "--device", "cpu", features_dir, str(tmp_path), "2"]) == 0
    (run,) = [d for d, _, files in os.walk(tmp_path) if "results.pkl" in files]
    with open(os.path.join(run, "results.pkl"), "rb") as f:
        assert json.loads(json.dumps(sorted(pickle.load(f)))) == ["test", "train", "valid"]
    assert os.path.relpath(run, str(tmp_path)).split(os.sep)[:2] == ["classifier", "us8k"]
