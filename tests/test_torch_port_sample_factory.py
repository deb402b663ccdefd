"""The port's AVC sample factory (stages 01 and 02) against the JAX
package's on the CPU: ``l3embedding_torch/data/{ontology,subsets,utils,
sample}.py``, ``ops/image.py``, ``native.py``, the ``01`` / ``02`` CLIs and
``tools/recompute_batch_audio.py``.

The cases of ``tests/test_subsets.py``, ``tests/test_sample_factory.py`` and
``tests/test_native.py``, each on the same input in both packages, with the
port's result held equal to JAX's (and to the original test's own checks);
then, from one seed, ``sample_and_save``'s h5 files equal JAX's key for key
and value for value (augmentation off and on, with metadata; with it on,
once with both packages on their native libraries and once with both on
numpy), the port's CLIs write the root scripts' CSVs and h5 files from the
same flags, and the port's repair tool rewrites batches as the root one
does. Where JAX reseeds the global ``random``, the port is given a
``random.Random`` of the same seed.
"""

import csv
import glob
import hashlib
import importlib.util
import json
import os
import random
import runpy
import subprocess
import sys
import warnings

import h5py
import numpy as np
import pytest

from l3embedding_tpu import native as jax_native
from l3embedding_tpu.data import sample as JS
from l3embedding_tpu.data import subsets as jax_subsets
from l3embedding_tpu.data.ontology import ASOntology as JaxOntology
from l3embedding_tpu.ops import image as JI
from l3embedding_tpu.training import data as jax_train_data
from l3embedding_torch import native
from l3embedding_torch.cli import create_subsets as cli01
from l3embedding_torch.data import sample as S
from l3embedding_torch.data import subsets
from l3embedding_torch.data.ontology import DEFAULT_ONTOLOGY, ASOntology
from l3embedding_torch.ops import image as I
from l3embedding_torch.tools import recompute_batch_audio as port_repair
from l3embedding_torch.training import data as train_data
from test_sample_factory import make_corpus
from torch_port_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, JAX_PLATFORMS="cpu", L3_FORCE_PLATFORM="cpu", OMP_NUM_THREADS="1")
FIELDS = ["ytid", "audio_filepath", "video_filepath"]


def write_subset(path, rows):
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=FIELDS)
        w.writeheader()
        w.writerows(rows)
    return path


def read_h5(path):
    with h5py.File(path, "r") as f:
        return {k: f[k][...] for k in f}


def assert_same_batches(dir_a, dir_b):
    """The same file names, and in each the same keys, dtypes, shapes and values."""
    names = sorted(os.listdir(dir_a))
    assert names and names == sorted(os.listdir(dir_b))
    for name in names:
        a, b = read_h5(os.path.join(dir_a, name)), read_h5(os.path.join(dir_b, name))
        assert sorted(a) == sorted(b), name
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, (name, k)
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name}:{k}")


# ---------------------------------------------------------------- subsets (tests/test_subsets.py)

NODES = [
    {"id": "/m/music", "name": "Music", "description": "", "citation_uri": "",
     "positive_examples": [], "child_ids": ["/m/guitar", "/m/drum"], "restrictions": []},
    {"id": "/m/guitar", "name": "Guitar", "description": "", "citation_uri": "",
     "positive_examples": [], "child_ids": ["/m/acoustic"], "restrictions": []},
    {"id": "/m/acoustic", "name": "Acoustic guitar", "description": "", "citation_uri": "",
     "positive_examples": [], "child_ids": [], "restrictions": []},
    {"id": "/m/drum", "name": "Drum", "description": "", "citation_uri": "",
     "positive_examples": [], "child_ids": [], "restrictions": ["abstract"]},
]


@pytest.fixture(scope="module")
def ontologies(tmp_path_factory):
    path = tmp_path_factory.mktemp("ont") / "ontology.json"
    path.write_text(json.dumps(NODES))
    return ASOntology(str(path)), JaxOntology(str(path))


def _items():
    return [
        {"ytid": "a", "labels": ["guitar"]},
        {"ytid": "b", "labels": ["acoustic guitar"]},
        {"ytid": "c", "labels": ["speech"]},
        {"ytid": "d", "labels": ["drum"]},
    ]


def _ontology_facts(ont):
    music = ont.get_node_by_name("Music")
    acoustic = ont.get_node_by_name("Acoustic guitar")
    return (music.is_child(acoustic), acoustic.is_child(music), acoustic.is_parent(music),
            ont.get_node("/m/drum").abstract, ont.top_level_node_ids, acoustic.parent.name,
            ont.get_node_by_name_ci("acoustic GUITAR").id)


def test_ontology_graph(ontologies):
    port, jax_ont = ontologies
    facts = _ontology_facts(port)
    assert facts == _ontology_facts(jax_ont)
    assert facts == (True, False, True, True, ["/m/music"], "Guitar", "/m/acoustic")
    # The repo's AudioSet ontology, the 01 stage's default, reads the same.
    full, jax_full = ASOntology(DEFAULT_ONTOLOGY), JaxOntology(DEFAULT_ONTOLOGY)
    assert full.top_level_node_ids == jax_full.top_level_node_ids and len(full._nodes) > 500


def _filtered(ontologies, filters, **kw):
    port, jax_ont = ontologies
    ours = [i["ytid"] for i in subsets.apply_filters(_items(), filters, port, **kw)]
    theirs = [i["ytid"] for i in jax_subsets.apply_filters(_items(), filters, jax_ont, **kw)]
    assert ours == theirs
    return ours


def test_filters_accept_label(ontologies):
    filters = [{"filter_type": "label", "accept_reject": "accept",
                "string": "Guitar", "include_children": "false"}]
    assert _filtered(ontologies, filters) == ["a"]


def test_filters_accept_with_children(ontologies):
    filters = [{"filter_type": "label", "accept_reject": "accept",
                "string": "Guitar", "include_children": "true"}]
    assert _filtered(ontologies, filters) == ["a", "b"]
    # compat_buggy_children reproduces the reference's no-op child filter.
    assert _filtered(ontologies, filters, compat_buggy_children=True) == ["a"]


def test_filters_reject_wins(ontologies):
    filters = [
        {"filter_type": "ytid", "accept_reject": "reject", "string": "a", "include_children": "false"},
        {"filter_type": "label", "accept_reject": "accept", "string": "Guitar",
         "include_children": "true"},
    ]
    assert _filtered(ontologies, filters) == ["b"]


def test_no_accept_filters_keeps_unmatched(ontologies):
    filters = [{"filter_type": "ytid", "accept_reject": "reject", "string": "c",
                "include_children": "false"}]
    assert _filtered(ontologies, filters) == ["a", "b", "d"]


def test_ytid_parsing():
    for name, want in (("abc_def_000_010", "abc_def"), ("xyz_0.0_10.5", "xyz")):
        assert subsets.get_ytid_from_filename(name) == jax_subsets.get_ytid_from_filename(name) == want


def _flat_corpus(root, n):
    (root / "audio").mkdir()
    (root / "video").mkdir()
    for i in range(n):
        name = f"vid{i:02d}_0_10"
        (root / "audio" / f"{name}.wav").write_bytes(b"")
        (root / "video" / f"{name}.npy").write_bytes(b"")


def test_subset_split_ratios(tmp_path):
    """A paired corpus of 20, 0.1 / 0.1 → 16 / 2 / 2, JAX's split row for
    row, and the writers' CSVs byte for byte."""
    _flat_corpus(tmp_path, 20)
    ours = subsets.get_subset_split(str(tmp_path), random_state=1)
    theirs = jax_subsets.get_subset_split(str(tmp_path), random_state=1)
    assert [len(x) for x in ours] == [16, 2, 2]
    assert ours == theirs
    assert len({x["ytid"] for part in ours for x in part}) == 20
    root01 = runpy.run_path(os.path.join(REPO, "01_create_subsets.py"), run_name="root_01")
    for name, part in zip(("train", "valid", "test"), ours):
        cli01.write_subset_file(str(tmp_path / f"port_{name}.csv"), part)
        root01["write_subset_file"](str(tmp_path / f"jax_{name}.csv"), part)
        assert (tmp_path / f"port_{name}.csv").read_bytes() == (tmp_path / f"jax_{name}.csv").read_bytes()


def test_get_file_list_finds_deeply_nested_corpora(tmp_path):
    deep = tmp_path / "train" / "eval_segments"
    shallow = tmp_path / "other"
    for base in (deep, shallow):
        (base / "audio").mkdir(parents=True)
        (base / "video").mkdir(parents=True)
    (deep / "audio" / "vidA_0_10.flac").write_bytes(b"x")
    (deep / "video" / "vidA_0_10.mp4").write_bytes(b"x")
    (shallow / "audio" / "vidB_0_10.flac").write_bytes(b"x")
    (shallow / "video" / "vidB_0_10.mp4").write_bytes(b"x")
    files = subsets.get_file_list(str(tmp_path))
    assert files == jax_subsets.get_file_list(str(tmp_path))
    assert sorted(f["ytid"] for f in files) == ["vidA", "vidB"]


# ---------------------------------------------------------------- factory (tests/test_sample_factory.py)

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("avc_corpus"))
    rows = make_corpus(root)
    return root, write_subset(os.path.join(root, "subset_train.csv"), rows), rows


def test_hsv_roundtrip():
    img = np.random.RandomState(3).rand(16, 16, 3)
    hsv = I.rgb_to_hsv(img)
    np.testing.assert_array_equal(hsv, JI.rgb_to_hsv(img))
    np.testing.assert_array_equal(I.hsv_to_rgb(hsv), JI.hsv_to_rgb(hsv))
    np.testing.assert_allclose(I.hsv_to_rgb(hsv), img, atol=1e-10)


def test_adjust_saturation_bounds():
    img = np.random.RandomState(4).rand(8, 8, 3)
    out = I.adjust_saturation(img, 1.5)
    np.testing.assert_array_equal(out, JI.adjust_saturation(img, 1.5))
    assert out.min() >= 0 and out.max() <= 1
    np.testing.assert_allclose(I.adjust_saturation(img, 1.0), img, atol=1e-10)
    for f in (lambda m: m.adjust_brightness(img, -0.1), lambda m: m.horiz_flip(img),
              lambda m: m.img_as_ubyte(img), lambda m: m.img_as_float(m.img_as_ubyte(img))):
        np.testing.assert_array_equal(f(I), f(JI))


def test_sample_one_second():
    """The same windows, starts and gains as JAX's from the same seed; the
    port's draws leave the global generator alone."""
    sr = 48000
    audio = (np.random.RandomState(0).randn(3 * sr) * 1000).astype(np.int16)
    random.seed(0)
    theirs = [JS.sample_one_second(audio, sr, augment=aug) for aug in (False,) * 5 + (True,) * 5]
    random.seed(1234)
    before = random.getstate()
    rng = random.Random(0)
    ours = [S.sample_one_second(audio, sr, augment=aug, rng=rng) for aug in (False,) * 5 + (True,) * 5]
    assert random.getstate() == before
    for (w, start, aug), (jw, jstart, jaug) in zip(ours, theirs):
        np.testing.assert_array_equal(w, jw)
        assert (start, aug) == (jstart, jaug)
        assert w.shape == (sr,) and w.dtype == np.int16 and 0 <= start <= 2.0
    assert all(o[2] == {} for o in ours[:5])
    assert all(0.9 <= o[2]["gain"] <= 1.1 for o in ours[5:])


def test_sample_one_second_pads_short_audio():
    sr = 48000
    short = np.ones(sr // 2, dtype=np.int16)
    with pytest.warns(UserWarning):
        window, start, _ = S.sample_one_second(short, sr, rng=random.Random(0))
    np.testing.assert_array_equal(window, JS.sample_one_second(short, sr)[0])
    assert window.shape == (sr,) and start == 0.0 and (window[sr // 2:] == 0).all()


def test_generate_sample_label_semantics():
    sr = 48000
    rs = np.random.RandomState(0)
    a1, a2 = ((rs.randn(2 * sr) * 500).astype(np.int16) for _ in range(2))
    v1, v2 = (rs.randint(0, 256, (60, 256, 320, 3)).astype(np.uint8) for _ in range(2))
    args = ("a1", a1, "a2", a2, "v1", v1, "v2", v2, sr)
    random.seed(123)
    theirs = [JS.generate_sample(*args, include_metadata=True) for _ in range(20)]
    rng = random.Random(123)
    ours = [S.generate_sample(*args, include_metadata=True, rng=rng) for _ in range(20)]
    labels = set()
    for s, j in zip(ours, theirs):
        assert sorted(s) == sorted(j)
        for k in s:
            np.testing.assert_array_equal(s[k], j[k])
        assert s["video"].shape == (224, 224, 3) and s["video"].dtype == np.uint8
        assert s["audio"].shape == (1, sr)
        assert tuple(s["label"]) in {(0, 1), (1, 0)}
        # label = [mismatch, match]: the two sources' names say which.
        assert s["label"][1] == (s["audio_file"][1:] == s["video_file"][1:])
        labels.add(tuple(s["label"]))
    assert len(labels) == 2


def test_stream_mux_replaces_dead_streamers():
    def run(mod):
        calls = []

        def good_factory():
            def gen():
                while True:
                    yield {"x": 1}
            calls.append("good")
            return gen()

        def dead_factory():
            def gen():
                raise mod.StreamerDead("nope")
                yield  # pragma: no cover
            calls.append("dead")
            return gen()

        mux = mod.StreamMux([dead_factory, good_factory], k=1, rate=4, random_state=0)
        return [next(mux) for _ in range(10)], calls, mux.dead_streamers

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ours, theirs = run(S), run(JS)
    assert ours == theirs
    assert all(s == {"x": 1} for s in ours[0]) and "good" in ours[1] and ours[2] >= 1


def test_sample_and_save_h5_schema(corpus, tmp_path):
    _, subset_csv, _ = corpus
    kw = dict(num_batches=2, num_streamers=2, batch_size=6, random_state=101, augment=True,
              include_metadata=True)
    S.sample_and_save(0, subset_csv, output_dir=str(tmp_path / "port"), **kw)
    JS.sample_and_save(0, subset_csv, output_dir=str(tmp_path / "jax"), **kw)
    assert_same_batches(str(tmp_path / "port"), str(tmp_path / "jax"))
    files = sorted(glob.glob(str(tmp_path / "port" / "*.h5")))
    assert [os.path.basename(f) for f in files] == ["101_0_0.h5", "101_0_1.h5"]
    b = read_h5(files[0])
    assert b["audio"].shape == (6, 1, 48000) and b["audio"].dtype == np.int16
    assert b["video"].shape == (6, 224, 224, 3) and b["video"].dtype == np.uint8
    assert b["label"].shape == (6, 2) and b["label"].dtype == np.int64
    assert "audio_file" in b and "video_gain" not in b
    assert "audio_gain" in b and "video_saturation_factor" in b
    assert ((b["video_bounding_box_start_x"] >= 0) & (b["video_bounding_box_start_x"] < 256 - 224)).all()
    assert ((b["video_bounding_box_start_y"] >= 0) & (b["video_bounding_box_start_y"] < 320 - 224)).all()


def test_factory_batches_feed_training_reader(corpus, tmp_path):
    """02 → 03: the port's factory files stream through the port's training
    data_generator, as JAX's files through JAX's."""
    _, subset_csv, _ = corpus
    kw = dict(num_batches=3, num_streamers=2, batch_size=4, random_state=7)
    S.sample_and_save(0, subset_csv, output_dir=str(tmp_path / "port"), **kw)
    JS.sample_and_save(0, subset_csv, output_dir=str(tmp_path / "jax"), **kw)
    ours = train_data.data_generator(str(tmp_path / "port"), batch_size=6, random_state=1)
    theirs = jax_train_data.data_generator(str(tmp_path / "jax"), batch_size=6, random_state=1)
    for _ in range(2):
        a, b = next(ours), next(theirs)
        assert sorted(a) == sorted(train_data.DEFAULT_KEYS) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert a["audio"].shape == (6, 1, 48000) and a["video"].shape == (6, 224, 224, 3)


def test_sample_and_save_is_reproducible(corpus, tmp_path):
    _, subset_csv, _ = corpus
    kw = dict(num_batches=2, num_streamers=2, batch_size=4, random_state=99, augment=True)
    for run in ("a", "b"):
        S.sample_and_save(0, subset_csv, output_dir=str(tmp_path / run), **kw)
    JS.sample_and_save(0, subset_csv, output_dir=str(tmp_path / "jax"), **kw)
    assert_same_batches(str(tmp_path / "a"), str(tmp_path / "b"))
    assert_same_batches(str(tmp_path / "a"), str(tmp_path / "jax"))


def test_small_frame_streamer_replaced_not_fatal(tmp_path):
    root = str(tmp_path / "corpus")
    rows = make_corpus(root, n_videos=3, seed=3)
    bad = np.random.RandomState(0).randint(0, 256, size=(30, 200, 200, 3)).astype(np.uint8)
    np.save(rows[1]["video_filepath"], bad)
    subset = write_subset(os.path.join(root, "subset.csv"), rows)
    kw = dict(batch_size=8, random_state=5, k=4, augment=False, rate=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ours, theirs = next(S.data_generator(subset, **kw)), next(JS.data_generator(subset, **kw))
    assert ours["video"].shape == (8, 224, 224, 3)
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])


def test_exact_224_frame_is_valid():
    frame = np.zeros((224, 240, 3), np.uint8)
    crop, bbox = S.sample_cropped_frame(frame, random.Random(0))
    random.seed(0)
    assert bbox == JS.sample_cropped_frame(frame)[1]
    assert crop.shape == (224, 224, 3) and bbox["start_x"] == 0
    with pytest.raises(ValueError, match="smaller"):
        S.sample_cropped_frame(np.zeros((200, 240, 3), np.uint8))


def test_single_video_subset_raises(tmp_path):
    root = str(tmp_path / "corpus")
    subset = write_subset(os.path.join(root, "subset.csv"), make_corpus(root, n_videos=1, seed=4))
    for mod in (S, JS):
        with pytest.raises(ValueError, match="2"):
            mod.data_generator(subset, batch_size=4, random_state=1, k=2)


# ---------------------------------------------------------------- native (tests/test_native.py)

def test_builds_and_loads():
    """The port's library is built from native/l3host.cpp into build/ (which
    .gitignore lists), not the tracked library beside the source."""
    assert native.available()
    lib = native.library_path()
    assert lib.exists() and lib.parent == native.BUILD_DIR
    assert lib.relative_to(REPO).parts[0] == "build"
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "build/" in f.read().split()


def test_pcm16_to_float():
    x = np.array([-32768, -1, 0, 1, 32767], dtype=np.int16)
    out = native.pcm16_to_float(x)
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, x.astype(np.float32) / 32768.0)
    np.testing.assert_array_equal(out, jax_native.pcm16_to_float(x))


def test_u8_to_pm1():
    x = np.arange(256, dtype=np.uint8)
    out = native.u8_to_pm1(x)
    np.testing.assert_allclose(out, 2.0 * (x.astype(np.float32) / 255.0) - 1.0, atol=1e-6)
    np.testing.assert_array_equal(out, jax_native.u8_to_pm1(x))


def test_gain_i16():
    x = (np.random.RandomState(0).randn(48000) * 8000).astype(np.int16)
    for gain in (0.9, 1.0, 1.1):
        out = native.gain_i16(x, gain)
        np.testing.assert_array_equal(out, np.clip(x.astype(np.float64) * gain, -32768, 32767).astype(np.int16))
        np.testing.assert_array_equal(out, jax_native.gain_i16(x, gain))


def test_augment_frame_matches_numpy():
    frame = np.random.RandomState(1).randint(0, 256, size=(32, 48, 3)).astype(np.uint8)
    for flip in (False, True):
        for sat_first in (False, True):
            got = native.augment_frame(frame, flip, 1.3, 0.05, sat_first)
            np.testing.assert_array_equal(got, jax_native.augment_frame(frame, flip, 1.3, 0.05, sat_first))
            want = native.augment_frame_plain(frame, flip, 1.3, 0.05, sat_first)
            diff = np.abs(got.astype(int) - want.astype(int))
            assert got.shape == want.shape and diff.max() <= 1 and (diff > 0).mean() < 0.02


def test_augment_identity():
    frame = np.full((8, 8, 3), 128, np.uint8)
    np.testing.assert_array_equal(native.augment_frame(frame, False, 1.0, 0.0, True), frame)


def test_resize_nn():
    frame = np.random.RandomState(2).randint(0, 256, size=(64, 96, 3)).astype(np.uint8)
    out = native.resize_nn(frame, 32, 48)
    yi = np.minimum(63, np.arange(32) * 64 // 32)
    xi = np.minimum(95, np.arange(48) * 96 // 48)
    np.testing.assert_array_equal(out, frame[yi][:, xi])
    np.testing.assert_array_equal(out, jax_native.resize_nn(frame, 32, 48))


def test_tracked_library_is_left_alone(monkeypatch, tmp_path):
    """A fresh build and load, and every entry point, leave the tracked
    native/libl3host.so byte for byte as it was."""
    tracked = os.path.join(REPO, "native", "libl3host.so")
    before = hashlib.sha256(open(tracked, "rb").read()).hexdigest()
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "l3host")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert native.available() and str(native.library_path()).startswith(str(tmp_path))
    frame = np.zeros((8, 8, 3), np.uint8)
    native.augment_frame(frame, True, 1.2, 0.1, False)
    native.resize_nn(frame, 4, 4)
    native.gain_i16(np.zeros(4, np.int16), 1.05)
    native.pcm16_to_float(np.zeros(4, np.int16))
    native.u8_to_pm1(frame)
    assert hashlib.sha256(open(tracked, "rb").read()).hexdigest() == before


def test_plain_fallback_is_loud(monkeypatch, caplog):
    """Without a compiler the numpy versions serve, available() is False and
    the fallback is logged at WARNING."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "build", lambda: None)
    with caplog.at_level("WARNING", logger="l3embedding_torch.native"):
        assert not native.available()
    assert any(r.levelname == "WARNING" and "numpy" in r.message for r in caplog.records)
    frame = np.random.RandomState(5).randint(0, 256, size=(16, 16, 3)).astype(np.uint8)
    np.testing.assert_array_equal(native.augment_frame(frame, True, 0.7, -0.1, True),
                                  native.augment_frame_plain(frame, True, 0.7, -0.1, True))


# ---------------------------------------------------------------- the packages' batches, bit for bit

@pytest.mark.parametrize("mode", ["plain", "augment_native", "augment_numpy"])
def test_sample_and_save_equals_jax(corpus, tmp_path, monkeypatch, mode):
    """From one seed, the port's h5 files equal JAX's key for key and value
    for value: augmentation off; on with metadata, both packages on their
    native libraries; on with metadata, both on numpy (loaders patched)."""
    _, subset_csv, _ = corpus
    augment = mode != "plain"
    if mode == "augment_numpy":
        monkeypatch.setattr(native, "_load", lambda: None)
        monkeypatch.setattr(jax_native, "_load", lambda: None)
    else:
        assert native.available() and jax_native.available()
    kw = dict(num_batches=2, num_streamers=3, batch_size=4, random_state=31, augment=augment,
              include_metadata=augment, rate=2.0)
    S.sample_and_save(1, subset_csv, output_dir=str(tmp_path / "port"), **kw)
    JS.sample_and_save(1, subset_csv, output_dir=str(tmp_path / "jax"), **kw)
    assert_same_batches(str(tmp_path / "port"), str(tmp_path / "jax"))
    b = read_h5(str(tmp_path / "port" / "32_1_0.h5"))
    assert ("video_saturation_factor" in b) == augment


# ---------------------------------------------------------------- CLIs and the repair tool

def test_01_cli_equals_root_script(tmp_path):
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    _flat_corpus(corpus, 13)
    flags = ["-vr", "0.2", "-tr", "0.15", "-r", "5"]
    cli01.main(flags + [str(corpus), str(tmp_path / "port"), "pre"])
    old = sys.argv
    sys.argv = ["01_create_subsets.py"] + flags + [str(corpus), str(tmp_path / "jax"), "pre"]
    try:
        runpy.run_path(os.path.join(REPO, "01_create_subsets.py"), run_name="__main__")
    finally:
        sys.argv = old
    for name in ("train", "valid", "test"):
        ours = (tmp_path / "port" / f"pre_{name}.csv").read_bytes()
        assert ours == (tmp_path / "jax" / f"pre_{name}.csv").read_bytes()
    parts = [list(csv.DictReader(open(tmp_path / "port" / f"pre_{n}.csv"))) for n in ("train", "valid", "test")]
    assert [len(p) for p in parts] == [10, 2, 1]
    assert sorted(r["ytid"] for p in parts for r in p) == [f"vid{i:02d}" for i in range(13)]


def test_02_cli_equals_root_script(corpus, tmp_path):
    """The same flags (2 workers, batch 4, augmentation, metadata, lzf) →
    the same h5 files."""
    _, subset_csv, _ = corpus
    flags = ["-n", "2", "-bs", "4", "-ns", "3", "-a", "-im", "-r", "3", "--h5-compression", "lzf",
             subset_csv, "12"]
    for cmd, out in (([sys.executable, "-m", "l3embedding_torch.cli.generate_samples"], "port"),
                     ([sys.executable, os.path.join(REPO, "02_generate_samples.py")], "jax")):
        res = subprocess.run(cmd + flags + [str(tmp_path / out)], capture_output=True, text=True,
                             env=ENV, cwd=REPO, timeout=240)
        assert res.returncode == 0, res.stderr[-3000:]
    assert sorted(os.listdir(tmp_path / "port")) == ["3_0_0.h5", "3_0_1.h5", "4_1_0.h5", "4_1_1.h5"]
    assert_same_batches(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_recompute_batch_audio_equals_root_tool(tmp_path, monkeypatch):
    """On the batches of tests/test_tools.py::test_recompute_batch_audio, from
    one state of the global generator, the port's tool rewrites the files as
    the root tool does; each row is the source slice × its new gain."""
    root = str(tmp_path / "corpus")
    rows = make_corpus(root, n_videos=3)
    subset_csv = write_subset(os.path.join(root, "subset.csv"), rows)
    for out in ("port", "jax"):
        S.sample_and_save(0, subset_csv, num_batches=2, output_dir=str(tmp_path / out),
                          num_streamers=2, batch_size=4, random_state=55, augment=True,
                          include_metadata=True)
    spec = importlib.util.spec_from_file_location("root_recompute", os.path.join(REPO, "recompute_batch_audio.py"))
    root_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root_tool)
    real_listdir = os.listdir
    monkeypatch.setattr(os, "listdir", lambda p: sorted(real_listdir(p)))
    before = read_h5(str(tmp_path / "port" / "55_0_0.h5"))
    random.seed(8)
    port_repair.main([str(tmp_path / "port"), subset_csv, "--verbose", "1"])
    random.seed(8)
    root_tool.process_subset(str(tmp_path / "jax"), subset_csv, verbose=1)
    assert_same_batches(str(tmp_path / "port"), str(tmp_path / "jax"))
    after = read_h5(str(tmp_path / "port" / "55_0_0.h5"))
    assert after["audio"].shape == before["audio"].shape
    assert not np.array_equal(after["audio_gain"], before["audio_gain"])
    gains = after["audio_gain"]
    assert np.all((gains >= 0.9) & (gains <= 1.1))
    src = {os.path.basename(r["audio_filepath"]): r["audio_filepath"] for r in rows}
    from l3embedding_torch.data.audio_io import read_audio, to_mono_int16

    for i, (name, start) in enumerate(zip(after["audio_file"], after["audio_start_sample_idx"])):
        data = to_mono_int16(read_audio(src[name.decode()])[0]).astype(float)
        want = (data[start:start + 48000] * gains[i]).astype(np.int16)
        np.testing.assert_array_equal(after["audio"][i, 0], want)


def test_factory_imports_without_h5py():
    """The card's machine has no h5py: the factory, its CLIs, the repair tool
    and the native binding import there, and sampling into memory works."""
    code = ("import sys; sys.modules['h5py'] = None\n"
            "import l3embedding_torch.data.sample, l3embedding_torch.cli.generate_samples\n"
            "import l3embedding_torch.cli.create_subsets, l3embedding_torch.tools.recompute_batch_audio\n"
            "from l3embedding_torch import native; print(native.available())\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=ENV, cwd=REPO,
                         timeout=120)
    assert res.returncode == 0 and res.stdout.split() == ["True"], res.stderr[-2000:]
