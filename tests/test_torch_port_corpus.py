"""The port's corpus pipeline (``l3embedding_torch/data/usc``, the ``05`` CLI
``l3embedding_torch.cli.generate_embedding_samples``) against the JAX
package's ``data/usc`` generators on the CPU.

tiny_L3 from one JAX-written ``.ckpt`` in the reference layout
``embedding/<subset>/<model_type>/<timestamp>/``, stdlib WAVs (one or two a
fold), hop 0.5. The port's CLI runs in process with ``--device cpu``; the
JAX side runs ``datasets.generate_*_folds`` in process with a JAX
``EmbeddingExtractor`` on the same checkpoint (never the JAX CLI in a
subprocess). Rows are held at the f32 gate, cosine >= 0.99999.
"""

import ast
import csv
import importlib.util
import json
import os
import pathlib
import sys

import numpy as np
import pytest
import torch

import jax

from l3embedding_tpu.data.usc import datasets as jax_datasets
from l3embedding_tpu.data.usc import features as jax_features
from l3embedding_tpu.data.usc import folds as jax_folds
from l3embedding_tpu.embed.extract import EmbeddingExtractor as JaxExtractor
from l3embedding_tpu.models import build_model as jax_build_model
from l3embedding_tpu.training.checkpoints import save_variables
from l3embedding_torch.cli import generate_embedding_samples as cli
from l3embedding_torch.data.audio_io import write_wav
from l3embedding_torch.data.usc import datasets, features, folds
from l3embedding_torch.embed.extract import EmbeddingRows
from torch_port_threads import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
SR = 48000
HOP = 0.5
TINY = "tiny_L3"
GATE = 0.99999
CLASSES = sorted(jax_datasets.DCASE2013_CLASS_TO_INT)


def _leaf(rng, path, shape):
    name = getattr(path[-1], "key", "")
    if name == "kernel":
        return rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[:-1]))
    if name == "scale":
        return 1.0 + 0.1 * rng.randn(*shape)
    if name == "var":
        return 1.0 + 0.3 * np.abs(rng.randn(*shape))
    return 0.05 * rng.randn(*shape)


def _tone(path, seconds, f0, seed):
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * SR)) / SR
    write_wav(path, 0.4 * np.sin(2 * np.pi * f0 * t) + 0.01 * rng.randn(t.size), SR)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The checkpoint and the three dataset layouts."""
    root = tmp_path_factory.mktemp("corpus")
    model = jax_build_model(TINY).module()
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), np.zeros((1, 224, 224, 3), np.float32),
        np.zeros((1, 1, SR), np.float32), train=False))
    rng = np.random.RandomState(5)
    v = {k: jax.tree_util.tree_map_with_path(lambda p, s: _leaf(rng, p, s.shape).astype(np.float32), shapes[k])
         for k in ("params", "batch_stats")}
    model_dir = root / "models" / "embedding" / "music_subset" / TINY / "20240101120000"
    model_dir.mkdir(parents=True)
    ckpt = str(model_dir / "model_best_valid_accuracy.ckpt")
    save_variables(ckpt, v["params"], v["batch_stats"])

    dcase = root / "dcase2013"
    for fold in (1, 2):
        (dcase / f"fold{fold}").mkdir(parents=True)
        for i, cls in enumerate(CLASSES[2 * fold: 2 * fold + 2]):
            _tone(str(dcase / f"fold{fold}" / f"{cls}{fold}{i}.wav"), 1.7, 400.0 + 900 * i, seed=fold * 10 + i)
    esc50 = root / "esc50"
    for fold in range(1, 6):
        (esc50 / f"fold{fold}").mkdir(parents=True)
        _tone(str(esc50 / f"fold{fold}" / f"{fold}-1000{fold}-A-{fold + 3}.wav"), 1.2, 300.0 * fold, seed=fold)
    us8k = root / "us8k"
    rows = [("100032-3-0-0.wav", 1, 3), ("100263-2-0-117.wav", 1, 2), ("102305-6-0-0.wav", 4, 6)]
    for fold in range(1, 11):
        (us8k / f"fold{fold}").mkdir(parents=True)
    for name, fold, cls in rows:
        _tone(str(us8k / f"fold{fold}" / name), 1.3, 500.0 + 200 * cls, seed=cls)
    _tone(str(us8k / "fold1" / "100032-3-0-0_pitch1.wav"), 1.3, 700.0, seed=99)  # an augmented variant
    meta = str(root / "UrbanSound8K.csv")
    with open(meta, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["slice_file_name", "fsID", "start", "end", "salience", "fold", "classID", "class"])
        for name, fold, cls in rows:
            w.writerow([name, name.split("-")[0], 0.0, 1.3, 1, fold, cls, f"c{cls}"])
    return {"root": root, "ckpt": ckpt, "dcase2013": str(dcase), "esc50": str(esc50), "us8k": str(us8k),
            "meta": meta}


@pytest.fixture(scope="module")
def jax_extractor(corpus):
    return JaxExtractor(corpus["ckpt"], TINY, "short")


def _npz_tree(top: str) -> dict:
    out = {}
    for dirpath, _, files in os.walk(top):
        for name in files:
            if name.endswith(".npz"):
                out[os.path.relpath(os.path.join(dirpath, name), top)] = os.path.join(dirpath, name)
    return out


def _min_cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return ((a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1) + 1e-30)).min()


def _jax_cli_keys(argv) -> set:
    """The keys the JAX 05 CLI writes to config_{fold}.json: its parsed
    arguments plus features_dir."""
    spec = importlib.util.spec_from_file_location("jax_05", REPO / "05_generate_embedding_samples.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    old = sys.argv
    sys.argv = ["05_generate_embedding_samples.py"] + argv
    try:
        return set(mod.parse_arguments()) | {"features_dir"}
    finally:
        sys.argv = old


JAX_GENERATORS = {
    "dcase2013": lambda c, out, **kw: jax_datasets.generate_dcase2013_folds(c["dcase2013"], out, **kw),
    "esc50": lambda c, out, **kw: jax_datasets.generate_esc50_folds(c["esc50"], out, **kw),
    "us8k": lambda c, out, **kw: jax_datasets.generate_us8k_folds(c["meta"], c["us8k"], out, **kw),
}


@pytest.mark.parametrize("dataset", ["dcase2013", "esc50", "us8k"])
def test_05_cli_writes_the_jax_tree(corpus, jax_extractor, tmp_path, dataset):
    """The port's 05 CLI writes the npz tree that JAX's generators write:
    the same files under features/<dataset>/l3/short/<subset>/tiny_L3/fold<k>/,
    keys, dtypes, shapes and y, rows at cosine >= 0.99999; config_None.json
    has the JAX CLI's keys plus the port's device, vggish_resources_dir
    (the JAX CLI reads VGGish weights from resources/vggish only) and
    whisper_weights (the port's --features whisper)."""
    argv = ["-lmp", corpus["ckpt"], "-lpt", "short", "-hs", str(HOP), dataset, corpus[dataset], str(tmp_path / "port")]
    if dataset == "us8k":
        argv[:0] = ["-ump", corpus["meta"]]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    out = tmp_path / "port" / "features" / dataset / "l3" / "short" / "music_subset" / TINY
    with open(out / "config_None.json") as f:
        config = json.load(f)
    assert set(config) == _jax_cli_keys(argv) | {"device", "vggish_resources_dir", "whisper_weights"}
    assert config["device"] == "cpu" and config["features_dir"] == str(out)

    theirs_dir = str(tmp_path / "jax")
    JAX_GENERATORS[dataset](corpus, theirs_dir, l3embedding_model=jax_extractor, features="l3",
                            random_state=20171021, hop_size=HOP, num_random_samples=None)
    ours, theirs = _npz_tree(str(out)), _npz_tree(theirs_dir)
    assert sorted(ours) == sorted(theirs) and ours
    if dataset == "us8k":
        assert "fold1/100032-3-0-0_pitch1.npz" in ours and len(ours) == 4
    for rel in ours:
        with np.load(ours[rel]) as a, np.load(theirs[rel]) as b:
            assert sorted(a.files) == sorted(b.files) == ["X", "y"]
            assert a["X"].dtype == b["X"].dtype == np.float32 and a["X"].shape == b["X"].shape
            assert a["y"].dtype == b["y"].dtype and a["y"].shape == b["y"].shape == ()
            assert int(a["y"]) == int(b["y"])
            assert _min_cos(a["X"], b["X"]) >= GATE, rel
    if dataset == "dcase2013":
        for fold_idx in range(2):  # the copied folds module over both trees
            mine, ref = folds.get_fold(str(out), fold_idx), jax_folds.get_fold(theirs_dir, fold_idx)
            assert mine["filenames"] == ref["filenames"] and np.array_equal(mine["labels"], ref["labels"])
            assert np.array_equal(mine["file_idxs"], ref["file_idxs"])
            assert _min_cos(mine["features"], ref["features"]) >= GATE


def test_05_cli_skips_existing_and_takes_one_fold(corpus, tmp_path):
    """--fold 2 writes only fold2 and config_2.json; a second run leaves the
    files it finds alone (the generators' idempotency)."""
    argv = ["-lmp", corpus["ckpt"], "-lpt", "short", "-hs", str(HOP), "--fold", "2", "--device", "cpu",
            "dcase2013", corpus["dcase2013"], str(tmp_path)]
    assert cli.main(argv) == 0
    out = tmp_path / "features" / "dcase2013" / "l3" / "short" / "music_subset" / TINY
    files = sorted(_npz_tree(str(out)))
    assert files and all(f.startswith("fold2/") for f in files)
    assert (out / "config_2.json").exists()
    stamps = {f: os.path.getmtime(out / f) for f in files}
    assert cli.main(argv) == 0
    assert {f: os.path.getmtime(out / f) for f in files} == stamps


def test_pending_writer_writes_behind(tmp_path):
    """_PendingWriter keeps up to `depth` handles pending and writes them in
    dispatch order through result() (an EmbeddingRows handle, which
    np.asarray does not take); what it writes equals a direct write."""
    rows = [np.random.RandomState(i).randn(3, 4).astype(np.float32) for i in range(3)]

    class Handle(EmbeddingRows):
        resolved = []

        def result(self):
            Handle.resolved.append(id(self))
            return super().result()

    handles = [Handle(torch.from_numpy(r)) for r in rows]
    paths = [str(tmp_path / f"f{i}.npz") for i in range(3)]
    with datasets._PendingWriter(depth=2) as w:
        w.add(paths[0], handles[0], 1)
        assert not os.path.exists(paths[0])
        w.add(paths[1], handles[1], 2)
        assert os.path.exists(paths[0]) and not os.path.exists(paths[1])
        w.add(paths[2], handles[2], 3)
    assert Handle.resolved == [id(h) for h in handles]
    for i, p in enumerate(paths):
        direct = str(tmp_path / f"d{i}.npz")
        np.savez_compressed(direct, X=rows[i], y=i + 1)
        with np.load(p) as a, np.load(direct) as b:
            assert np.array_equal(a["X"], b["X"]) and int(a["y"]) == i + 1 == int(b["y"])


def test_05_cli_refuses_vggish_and_int8_tiny(corpus, tmp_path):
    """--features vggish refuses VGGish weights of the wrong shapes (the
    baseline itself runs: tests/test_torch_port_vggish.py); an unknown
    feature type raises; --int8 on tiny_L3 raises JAX's refusal."""
    base = ["-lmp", corpus["ckpt"], "--device", "cpu", "dcase2013", corpus["dcase2013"], str(tmp_path)]
    bad = tmp_path / "vggish"
    bad.mkdir()
    np.savez(bad / "vggish_model.npz", **{"vggish/fc2/weights": np.zeros((128, 4096), np.float32)})
    with pytest.raises(ValueError, match="shape mismatch for vggish/fc2/weights"):
        cli.main(["--features", "vggish", "--vggish-resources-dir", str(bad)] + base)
    with pytest.raises(ValueError, match="int8 quantization supports the full L3 audio towers; "
                                         "'tiny_L3' uses TinyL3AudioTower"):
        cli.main(["--int8"] + base)
    with pytest.raises(ValueError, match="Invalid feature type: vggish2"):
        features.compute_file_features("x.wav", "vggish2")


def test_preprocessing_equals_jax():
    """The copied host-side preprocessing (overlap removal, stats mode,
    scaling; sklearn imported inside) gives JAX's arrays."""
    rng = np.random.RandomState(0)

    def split():
        data = {"features": rng.randn(24, 5), "labels": np.arange(4) % 2,
                "file_idxs": np.array([[0, 6], [6, 12], [12, 18], [18, 24]])}
        return data

    for mode in ("framewise", "stats"):
        a = [split() for _ in range(3)]
        b = [{k: np.array(v, copy=True) for k, v in d.items()} for d in a]
        np.random.seed(1)
        features.preprocess_split_data(*a, feature_mode=mode, non_overlap=True, non_overlap_chunk_size=2,
                                       use_min_max=True)
        np.random.seed(1)
        jax_features.preprocess_split_data(*b, feature_mode=mode, non_overlap=True, non_overlap_chunk_size=2,
                                           use_min_max=True)
        for x, y in zip(a, b):
            np.testing.assert_allclose(x["features"], y["features"], rtol=1e-12)
            np.testing.assert_array_equal(x["labels"], y["labels"])


def test_features_module_imports_no_sklearn_at_module_level():
    """The 05 stage starts on a machine without scikit-learn: no top-level
    statement of data/usc/features.py imports it."""
    path = REPO / "l3embedding_torch" / "data" / "usc" / "features.py"
    top = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Import):
            top += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            top.append(node.module or "")
    assert top and not [m for m in top if m.split(".")[0] == "sklearn"]
    assert "sklearn" in path.read_text()  # imported inside preprocess_split_data
