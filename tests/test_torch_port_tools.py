"""The port's host tools and report inputs against the JAX package's:
``l3embedding_torch/tools/{export_embedding_model,import_keras_checkpoint,
export_keras_checkpoint}.py`` against the root ``tools/`` scripts of the
same names, the root report scripts (``04_plot_training_history.py``,
``generate_plots_and_sig_tests.py``) on the port's outputs, and
``l3embedding_torch/utils/gsheets.py`` on the local-sheet and request-shape
cases of ``tests/test_trackers.py``."""

import importlib.util
import json
import os
import pickle
import subprocess
import sys

import h5py
import numpy as np
import pytest
import torch

from l3embedding_tpu.compat import keras_export as jax_export
from l3embedding_tpu.compat.keras_synth import synthesize_keras_h5
from l3embedding_tpu.embed.extract import load_exported_embedding as jax_load_exported
from l3embedding_tpu.training.checkpoints import save_variables as jax_save_variables
from l3embedding_torch.classifier.train import train as classifier_train
from l3embedding_torch.compat.keras_import import import_avc_weights
from l3embedding_torch.compat.to_jax import avc_to_jax_variables
from l3embedding_torch.embed.extract import EmbeddingExtractor, load_exported_embedding
from l3embedding_torch.models.registry import build_model
from l3embedding_torch.tools import export_embedding_model, export_keras_checkpoint, import_keras_checkpoint
from l3embedding_torch.training.checkpoints import read_tree
from l3embedding_torch.training.loop import train as port_train
from l3embedding_torch.utils import gsheets
from test_downstream import make_features_dir
from test_torch_port_trainloop import ARGS, make_corpus
from torch_port_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = "tiny_L3"


def _root_script(name, path):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_root_tool(path, argv):
    """A root tools/ script's main() in this process, with argv."""
    mod = _root_script("root_" + os.path.basename(path)[:-3], path)
    old = sys.argv
    sys.argv = [path] + argv
    try:
        mod.main()
    finally:
        sys.argv = old


def flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, prefix + (k,)))
        return out
    return {prefix: np.asarray(tree)}


def assert_trees_identical(a, b):
    fa, fb = flat(a), flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].tobytes() == fb[k].tobytes(), k


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    """A seeded tiny_L3 AVC .ckpt written by JAX's writer."""
    model = build_model(TINY).module()
    model.reset_parameters(torch.Generator().manual_seed(21))
    v = avc_to_jax_variables(model, TINY)
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny.ckpt")
    jax_save_variables(path, v["params"], v["batch_stats"])
    return path


def _min_cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    return ((a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1) + 1e-30)).min()


def test_export_embedding_model_audio_read_by_both_packages(tiny_ckpt, tmp_path):
    """The port's audio export: the same descriptor and .ckpt tree as the
    root tool's; both packages' load_exported_embedding read it, with rows
    at the f32 gate against the extractor of the full .ckpt."""
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    argv = ["--model-type", TINY, "--embedding", "audio", "--pooling", "short"]
    assert export_embedding_model.main([tiny_ckpt, *argv, "--output", ours]) == 0
    _run_root_tool("tools/export_embedding_model.py", [tiny_ckpt, *argv, "--output", theirs])
    assert_trees_identical(read_tree(ours + ".ckpt"), read_tree(theirs + ".ckpt"))
    with open(ours + ".json") as f, open(theirs + ".json") as g:
        desc, want = json.load(f), json.load(g)
    assert desc.pop("framework") == "l3embedding_torch" and want.pop("framework") == "l3embedding_tpu"
    assert desc == want
    windows = (np.random.RandomState(6).randn(3, 48000) * 0.1).astype(np.float32)
    rows = load_exported_embedding(ours, device="cpu").embed_windows(windows)
    full = EmbeddingExtractor(tiny_ckpt, TINY, "short", device="cpu").embed_windows(windows)
    np.testing.assert_array_equal(rows, full)
    assert _min_cos(np.asarray(jax_load_exported(ours).embed_windows(windows)), rows) >= 0.99999


def test_export_embedding_model_frontend_and_h5(tmp_path):
    """--embedding frontend writes the root tool's descriptor alone; a
    reference .h5 exports the tower its Keras import gives."""
    ours, theirs = str(tmp_path / "fe_port"), str(tmp_path / "fe_jax")
    argv = ["unused", "--model-type", "cnn_L3_melspec2", "--embedding", "frontend", "--kapre-batch-global-db"]
    assert export_embedding_model.main([*argv, "--output", ours]) == 0
    _run_root_tool("tools/export_embedding_model.py", [*argv, "--output", theirs])
    assert not os.path.exists(ours + ".ckpt")
    with open(ours + ".json") as f, open(theirs + ".json") as g:
        desc, want = json.load(f), json.load(g)
    desc.pop("framework"), want.pop("framework")
    assert desc == want and desc["db_batch_global"] is True
    h5 = str(tmp_path / "model.h5")
    synthesize_keras_h5(h5, np.random.RandomState(3))
    assert export_embedding_model.main([h5, "--model-type", "cnn_L3_melspec2", "--embedding", "vision",
                                        "--output", str(tmp_path / "vision")]) == 0
    v = import_avc_weights(h5, "cnn_L3_melspec2")
    assert_trees_identical(read_tree(str(tmp_path / "vision.ckpt")),
                           {"params": {"vision_model": v["params"]["vision_model"]},
                            "batch_stats": {"vision_model": v["batch_stats"]["vision_model"]}})
    with open(str(tmp_path / "vision.json")) as f:
        assert json.load(f)["n_params"] == sum(a.size for a in flat(v["params"]["vision_model"]).values())


def test_keras_tools_both_ways(tmp_path):
    """import_keras_checkpoint writes the .ckpt JAX's writer writes for the
    imported tree, byte for byte, and flax's msgpack reads it;
    export_keras_checkpoint writes the file JAX's exporter writes from it."""
    from flax import serialization

    h5 = str(tmp_path / "model.h5")
    synthesize_keras_h5(h5, np.random.RandomState(5))
    ckpt = str(tmp_path / "out" / "model.ckpt")
    assert import_keras_checkpoint.main([h5, "cnn_L3_melspec2", ckpt]) == 0
    v = import_avc_weights(h5, "cnn_L3_melspec2")
    want = str(tmp_path / "jax.ckpt")
    jax_save_variables(want, v["params"], v["batch_stats"])
    with open(ckpt, "rb") as f, open(want, "rb") as g:
        blob = f.read()
        assert blob == g.read()
    assert_trees_identical(serialization.msgpack_restore(blob), v)
    out = str(tmp_path / "back" / "model.h5")
    assert export_keras_checkpoint.main([ckpt, "cnn_L3_melspec2", out]) == 0
    ref = str(tmp_path / "jax.h5")
    jax_export.export_avc_weights(v, "cnn_L3_melspec2", ref)
    with h5py.File(out, "r") as fo, h5py.File(ref, "r") as fr:
        names = []
        fr.visit(names.append)
        seen = []
        fo.visit(seen.append)
        assert seen == names
        for name in names:
            if isinstance(fr[name], h5py.Dataset):
                assert np.asarray(fo[name]).tobytes() == np.asarray(fr[name]).tobytes(), name
    assert_trees_identical(import_avc_weights(out, "cnn_L3_melspec2"), v)


def test_plot_training_history_reads_a_port_run(tmp_path):
    """04_plot_training_history.py, as a subprocess, plots a port training
    run's history_csvlog.csv."""
    make_corpus(str(tmp_path / "train_h5"), 2, 8, 0)
    make_corpus(str(tmp_path / "valid_h5"), 1, 8, 1)
    model_dir, _ = port_train(str(tmp_path / "train_h5"), str(tmp_path / "valid_h5"), str(tmp_path / "runs"),
                              device="cpu", **dict(ARGS, train_epoch_size=2, validation_epoch_size=1))
    png = str(tmp_path / "history.png")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "04_plot_training_history.py"),
         os.path.join(model_dir, "history_csvlog.csv"), "--hide-display", "-o", png],
        capture_output=True, text=True, env={**os.environ, "MPLBACKEND": "Agg"}, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    with open(png, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_report_loader_reads_a_port_results_pkl(tmp_path):
    """generate_plots_and_sig_tests.py's loader collects a port train()
    run's results.pkl: its representation, fold and accuracies."""
    feats = make_features_dir(str(tmp_path / "ds"), num_folds=10, files_per_fold=10, frames=4, dim=8)
    np.random.seed(0)
    model_dir, results = classifier_train(feats, str(tmp_path / "cls"), fold_num=3, model_type="svm",
                                          random_state=5, device="cpu")
    report = _root_script("report", "generate_plots_and_sig_tests.py")
    (row,) = report.collect_results_from_tree(str(tmp_path / "cls"))
    assert row["fold"] == 3
    assert row["representation"] == os.path.dirname(
        os.path.relpath(os.path.dirname(model_dir), str(tmp_path / "cls" / "classifier")))
    assert row["test_acc"] == pytest.approx(results["test"]["accuracy"])
    assert row["test_avg_class_acc"] == pytest.approx(results["test"]["average_class_accuracy"])


# ------------------------------------------------------------------ gsheets

def test_gsheets_local_surface(tmp_path):
    creds = gsheets.get_credentials("test-app", spreadsheet_path=str(tmp_path / "sheet.json"))
    service = gsheets.build_service(creds, "any-id")
    params = {"username": "u", "model_dir": "/runs/x", "model_type": "cnn_L3_orig"}
    assert gsheets.get_row(service, "any-id", params, "embedding") is None
    gsheets.append_row(service, "any-id", params, "embedding")
    assert gsheets.get_row(service, "any-id", params, "embedding") == 0
    # Metric update between columns R..Z (reference train.py:102-105).
    gsheets.update_experiment(service, "any-id", params, "R", "Z",
                              [5, 0.1, 0.2, 0.8, 0.7, 0.1, 0.2, 0.8, 0.7], "embedding")
    rows = service.get_rows("embedding")
    assert rows[0][17] == "5"  # column R
    gsheets.update_experiment(service, "any-id", params, "R", "Z", [6] * 9, "embedding")
    assert len(service.get_rows("embedding")) == 1
    with open(tmp_path / "sheet.json") as f:
        assert json.load(f)["embedding"][0][:3] == ["u", "/runs/x", "cnn_L3_orig"]


def test_gsheets_google_backend_request_shapes():
    """GoogleSheet drives the Sheets v4 API with the reference's request
    shapes against an in-memory double of googleapiclient's chained
    interface: values().append for new rows, values().update with an A1
    range."""
    calls, store = [], []

    class _Req:
        def __init__(self, kind, kwargs):
            self._kind, self._kw = kind, kwargs

        def execute(self):
            calls.append((self._kind, self._kw))
            if self._kind == "get":
                return {"values": store}
            if self._kind == "append":
                store.append(self._kw["body"]["values"][0])
            if self._kind == "update":
                cell = self._kw["range"].split("!")[1].split(":")[0]
                row = int("".join(c for c in cell if c.isdigit())) - 1
                col = gsheets._col_letter_to_idx("".join(c for c in cell if c.isalpha()))
                vals = self._kw["body"]["values"][0]
                r = store[row]
                r.extend([""] * max(0, col + len(vals) - len(r)))
                r[col: col + len(vals)] = vals
            return {}

    class _Values:
        def get(self, **kw):
            return _Req("get", kw)

        def append(self, **kw):
            return _Req("append", kw)

        def update(self, **kw):
            return _Req("update", kw)

    class _Service:
        def spreadsheets(self):
            return type("S", (), {"values": lambda self: _Values()})()

    sheet = gsheets.GoogleSheet(_Service(), "sheet-id-1")
    params = {"model_dir": "/x/run1", "username": "t"}
    gsheets.append_row(sheet, "sheet-id-1", params, "classifier")
    assert gsheets.get_row(sheet, "sheet-id-1", params, "classifier") == 0
    gsheets.update_experiment(sheet, "sheet-id-1", params, "B", "C", ["0.9", "0.8"], "classifier")
    assert store[0][1:3] == ["0.9", "0.8"]
    kinds = [k for k, _ in calls]
    assert "append" in kinds and "update" in kinds
    upd = next(kw for k, kw in calls if k == "update")
    assert upd["range"] == "classifier!B1:C1"
    assert upd["spreadsheetId"] == "sheet-id-1" and upd["valueInputOption"] == "USER_ENTERED"
    app = next(kw for k, kw in calls if k == "append")
    assert (app["range"], app["insertDataOption"]) == ("classifier!A1:A1", "INSERT_ROWS")
    assert [gsheets._col_idx_to_letter(i) for i in (0, 25, 26, 701)] == ["A", "Z", "AA", "ZZ"]


def test_google_credentials_user_token_and_garbage(tmp_path, monkeypatch):
    """A stored user OAuth2 token through L3_GOOGLE_USER_TOKEN and the
    reference's ~/.credentials/<app>.json; an unreadable file falls back to
    the local sheet without raising."""
    pytest.importorskip("google.oauth2")
    from google.oauth2.credentials import Credentials as UserCreds

    user = tmp_path / "myapp.json"
    user.write_text(json.dumps({"type": "authorized_user", "client_id": "c.apps.googleusercontent.com",
                                "client_secret": "s", "refresh_token": "r"}))
    for var in ("L3_GOOGLE_CREDENTIALS", "GOOGLE_APPLICATION_CREDENTIALS", "L3_GOOGLE_USER_TOKEN"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("L3_GOOGLE_USER_TOKEN", str(user))
    marker = gsheets.get_credentials("myapp")
    assert isinstance(marker["google_credentials"], UserCreds)
    assert marker["google_credentials"].refresh_token == "r"
    monkeypatch.delenv("L3_GOOGLE_USER_TOKEN")
    monkeypatch.setenv("HOME", str(tmp_path))
    (tmp_path / ".credentials").mkdir()
    (tmp_path / ".credentials" / "myapp.json").write_text(user.read_text())
    assert isinstance(gsheets.get_credentials("myapp")["google_credentials"], UserCreds)
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    monkeypatch.setenv("L3_GOOGLE_CREDENTIALS", str(bad))
    monkeypatch.setenv("HOME", "/nonexistent-home")
    marker = gsheets.get_credentials("myapp")
    assert "google_credentials" not in marker
    assert isinstance(gsheets.build_service(marker, str(tmp_path / "s.json")), gsheets.LocalSheet)


def test_adc_authorized_user_not_loaded(tmp_path, monkeypatch):
    """GOOGLE_APPLICATION_CREDENTIALS holding a gcloud user token is not
    loaded (it usually lacks the Sheets scope): the local sheet serves."""
    adc = tmp_path / "adc.json"
    adc.write_text(json.dumps({"type": "authorized_user", "client_id": "c.apps.googleusercontent.com",
                               "client_secret": "s", "refresh_token": "r"}))
    for var in ("L3_GOOGLE_CREDENTIALS", "L3_GOOGLE_USER_TOKEN"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("GOOGLE_APPLICATION_CREDENTIALS", str(adc))
    monkeypatch.setenv("HOME", "/nonexistent-home")
    assert "google_credentials" not in gsheets.get_credentials("myapp")


def test_classifier_tracker_row_through_the_jsonl_tracker(tmp_path):
    """train(gsheet_id=...) tracks the run locally: the config row, then the
    metric update, in the classifier schema's columns."""
    feats = make_features_dir(str(tmp_path / "ds"), num_folds=10, files_per_fold=10, frames=4, dim=8)
    np.random.seed(0)
    model_dir, _ = classifier_train(feats, str(tmp_path / "cls"), fold_num=1, model_type="svm",
                                    random_state=5, gsheet_id="sheet", device="cpu")
    with open(tmp_path / "cls" / "classifier_experiments.jsonl") as f:
        events = [json.loads(line) for line in f]
    assert [e["event"] for e in events] == ["upsert", "update"]
    assert events[1]["model_dir"] == model_dir
    assert set(events[1]["values"]) <= set(gsheets._SHEET_FIELDS["classifier"]) | {
        "train_loss", "valid_loss", "train_avg_class_acc"}
    with open(os.path.join(model_dir, "results.pkl"), "rb") as f:
        assert events[1]["values"]["test_acc"] == pickle.load(f)["test"]["accuracy"]
