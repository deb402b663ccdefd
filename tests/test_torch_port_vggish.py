"""The port's VGGish baseline (``models/vggish.py``, ``data/vggish_mel.py``,
the ``vggish`` branch of ``data/usc/features.py`` and of the 05 CLI)
against the JAX package's on the CPU.

The repository holds no pretrained VGGish weights and no PCA parameters,
so every comparison runs on one seeded set of flax-layout weights, carried
into the port with ``compat.from_jax.vggish_from_jax`` and written with
``save_vggish_npz`` to the npz layout (``vggish/<scope>/weights|biases``)
that both packages' ``load_vggish_weights`` read; both sides load that one
file. Gates: rows at cosine >= 0.99999 and max |Δ| <= 1e-4 of the row's
largest value; postprocessed uint8 rows equal but for ±1 at rounding ties.
"""

import os

import numpy as np
import pytest
import torch

import jax

from l3embedding_tpu.data import vggish_mel as jax_mel
from l3embedding_tpu.data.usc import datasets as jax_datasets
from l3embedding_tpu.models import vggish as jax_vggish
from l3embedding_torch.cli import generate_embedding_samples as cli
from l3embedding_torch.compat.from_jax import vggish_from_jax
from l3embedding_torch.data import vggish_mel
from l3embedding_torch.data.audio_io import write_wav
from l3embedding_torch.data.usc import features
from l3embedding_torch.models import vggish

from test_torch_port_corpus import corpus  # noqa: F401  (the 05 fixture corpus)
from torch_port_threads import one_torch_thread  # noqa: F401

GATE = 0.99999


def _cos_rows(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1) + 1e-30)


def _sine(seconds=3.0, sr=44100, f0=1000.0):
    t = np.arange(int(seconds * sr)) / sr
    return 0.5 * np.sin(2 * np.pi * f0 * t) + 0.05 * np.sin(2 * np.pi * 3100.0 * t), sr


@pytest.fixture(scope="module")
def resources(tmp_path_factory):
    """A resources dir with one seeded ``vggish_model.npz`` and a seeded
    ``vggish_pca_params.npz`` (and a second dir with a link to the same
    weights alone)."""
    shapes = jax.eval_shape(
        lambda: jax_vggish.VGGish().init(jax.random.PRNGKey(0), np.zeros((1, 96, 64), np.float32)))
    rng = np.random.RandomState(17)

    def leaf(path, s):
        if path[-1].key == "kernel":
            return (rng.randn(*s.shape) * np.sqrt(2.0 / np.prod(s.shape[:-1]))).astype(np.float32)
        return (0.01 * rng.randn(*s.shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(leaf, shapes["params"])
    model = vggish.VGGish()
    model.load_state_dict(vggish_from_jax(params))
    root = tmp_path_factory.mktemp("vggish")
    dirs = {name: str(root / name) for name in ("pca", "plain")}
    for d in dirs.values():
        os.makedirs(d)
    vggish.save_vggish_npz(os.path.join(dirs["plain"], "vggish_model.npz"), model)
    os.symlink(os.path.join(dirs["plain"], "vggish_model.npz"), os.path.join(dirs["pca"], "vggish_model.npz"))
    q, _ = np.linalg.qr(rng.randn(128, 128))
    np.savez(os.path.join(dirs["pca"], "vggish_pca_params.npz"),
             pca_eigen_vectors=q * 4.0, pca_means=0.2 * rng.randn(128))
    return dirs, params


def _jax_params(path, template):
    """JAX's load_vggish_weights of the npz (`template` gives it the tree's
    shapes; every leaf is replaced from the file)."""
    zeros = jax.tree.map(lambda x: np.zeros_like(x), template)
    return jax_vggish.load_vggish_weights(path, zeros)


def test_vggish_mel_equals_jax():
    """The numpy front end is JAX's, bit for bit: the mel matrix, a log-mel
    spectrogram and the examples of a 44.1 kHz clip (resampled) at two hops."""
    kw = dict(num_mel_bins=64, num_spectrogram_bins=257, audio_sample_rate=16000,
              lower_edge_hertz=125, upper_edge_hertz=7500)
    np.testing.assert_array_equal(vggish_mel.spectrogram_to_mel_matrix(**kw),
                                  jax_mel.spectrogram_to_mel_matrix(**kw))
    x, sr = _sine()
    for hop in (0.96, 0.25):
        a = vggish_mel.waveform_to_examples(x, sr, frame_hop_sec=hop)
        b = jax_mel.waveform_to_examples(x, sr, frame_hop_sec=hop)
        assert a.shape == b.shape and a.shape[1:] == (96, 64)
        np.testing.assert_array_equal(a, b)
    stereo = np.stack([x, 0.5 * x], 1)
    np.testing.assert_array_equal(vggish_mel.waveform_to_examples(stereo, sr),
                                  jax_mel.waveform_to_examples(stereo, sr))


def test_parameter_count():
    assert sum(p.numel() for p in vggish.VGGish().parameters()) == 72_141_184


def test_forward_equals_jax_from_one_npz(resources):
    """Both packages load the one seeded npz; at batch 2 every row at cosine
    >= 0.99999 and within 1e-4 of the largest value; the port's loaded
    weights are the seeded ones, exactly."""
    dirs, params = resources
    path = os.path.join(dirs["plain"], "vggish_model.npz")
    model = vggish.load_vggish_weights(path, vggish.VGGish())
    for k, t in vggish_from_jax(params).items():
        assert torch.equal(model.state_dict()[k], t), k
    x = np.random.RandomState(3).randn(2, 96, 64).astype(np.float32) * 2.0
    with torch.no_grad():
        ours = model(torch.from_numpy(x)).numpy()
        ours4 = model(torch.from_numpy(x[..., None])).numpy()
    theirs = np.asarray(jax_vggish.VGGish().apply({"params": _jax_params(path, params)}, x))
    np.testing.assert_array_equal(ours, ours4)
    cos = _cos_rows(ours, theirs)
    rel = (np.abs(ours - theirs).max(1) / np.abs(theirs).max(1)).max()
    print(f"VGGish forward vs JAX: min cosine {cos.min():.8f}, max relative difference {rel:.2e}")
    assert ours.shape == (2, 128) and (ours >= 0).all()
    assert cos.min() >= GATE and rel <= 1e-4


def test_fc1_flatten_is_jax_order():
    """fc1_1 reads the (6, 4, 512) map in H·W·C order: a kernel row set for
    one (h, w, c) position picks that position's value."""
    model = vggish.VGGish()
    feat = torch.zeros(1, 512, 6, 4)
    feat[0, 7, 2, 3] = 1.0
    with torch.no_grad():
        flat = feat.permute(0, 2, 3, 1).flatten(1)
    assert int(flat.argmax()) == (2 * 4 + 3) * 512 + 7
    assert model.fcs["fc1_1"].in_features == 6 * 4 * 512


def test_postprocessor_equals_jax(resources):
    """The PCA + uint8 postprocessor: JAX's on the same rows, bit for bit;
    on each package's own rows, equal but for ±1 at rounding ties (the
    count is printed)."""
    dirs, _ = resources
    pca = os.path.join(dirs["pca"], "vggish_pca_params.npz")
    ours_pp, theirs_pp = vggish.Postprocessor(pca), jax_vggish.Postprocessor(pca)
    rows = np.abs(np.random.RandomState(4).randn(6, 128)).astype(np.float32)
    np.testing.assert_array_equal(ours_pp.postprocess(rows), theirs_pp.postprocess(rows))
    np.testing.assert_array_equal(ours_pp.postprocess(rows, quantize=False),
                                  theirs_pp.postprocess(rows, quantize=False))
    x, sr = _sine()
    ex = vggish.VGGishExtractor(dirs["pca"], device="cpu")
    ours = ex.embed_waveform(x, sr, postprocess=True)
    theirs = jax_vggish.VGGishExtractor.get_cached(dirs["pca"]).embed_waveform(x, sr, postprocess=True)
    d = np.abs(ours.astype(np.int32) - theirs.astype(np.int32))
    print(f"postprocessed rows: {int((d > 0).sum())} of {d.size} values differ by one level")
    assert ours.dtype == np.float32 and ours.shape == theirs.shape == (3, 128)
    assert d.max() <= 1


def test_embed_file_equals_jax(resources, tmp_path):
    """embed_file on a stdlib WAV (22.05 kHz stereo, resampled to 16 kHz) and
    on a clip shorter than one example (padded): rows at the f32 gate."""
    dirs, _ = resources
    x, _ = _sine(2.2, 22050, 700.0)
    long_wav, short_wav = str(tmp_path / "long.wav"), str(tmp_path / "short.wav")
    write_wav(long_wav, np.stack([x, 0.3 * x], 1), 22050)
    write_wav(short_wav, x[:9000], 22050)
    ours_ex = vggish.VGGishExtractor(dirs["plain"], device="cpu")
    theirs_ex = jax_vggish.VGGishExtractor.get_cached(dirs["plain"])  # the 05 test's too
    assert ours_ex.has_weights and ours_ex.postprocessor is None
    for path, hop in ((long_wav, 0.25), (short_wav, 0.96)):
        ours, theirs = ours_ex.embed_file(path, hop_size=hop), theirs_ex.embed_file(path, hop_size=hop)
        assert ours.shape == theirs.shape and ours.shape[1] == 128
        assert _cos_rows(ours, theirs).min() >= GATE


def test_seeded_init_without_weights(tmp_path, caplog):
    """No vggish_model.npz: a seeded init, the same for the same seed,
    with a warning; compute_file_features dispatches to the cached one."""
    a = vggish.VGGishExtractor.get_cached(str(tmp_path), "cpu")
    b = vggish.VGGishExtractor(str(tmp_path), device="cpu")
    assert vggish.VGGishExtractor.get_cached(str(tmp_path), "cpu") is a
    assert not a.has_weights and a.postprocessor is None
    assert "random init" in caplog.text
    for (k, t), u in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(t, u), k
    x, sr = _sine(1.5)
    path = str(tmp_path / "clip.wav")
    write_wav(path, x, sr)
    rows = features.compute_file_features(path, "vggish", hop_size=0.5, resources_dir=str(tmp_path),
                                          device="cpu")
    np.testing.assert_array_equal(rows, a.embed_file(path, hop_size=0.5))


def test_load_refuses_tf_checkpoints_and_bad_shapes(tmp_path):
    with pytest.raises(RuntimeError, match="export the TF checkpoint"):
        vggish.load_vggish_weights(str(tmp_path / "vggish_model.ckpt"), vggish.VGGish())
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, **{"vggish/conv1/weights": np.zeros((3, 3, 2, 64), np.float32)})
    with pytest.raises(ValueError, match="shape mismatch for vggish/conv1/weights"):
        vggish.load_vggish_weights(bad, vggish.VGGish())


def _tree(top):
    out = {}
    for dirpath, _, files in os.walk(top):
        for name in files:
            if name.endswith(".npz"):
                with np.load(os.path.join(dirpath, name)) as z:
                    out[os.path.relpath(os.path.join(dirpath, name), top)] = (z["X"], int(z["y"]))
    return out


def test_05_vggish_tree_equals_jax(corpus, resources, tmp_path):  # noqa: F811
    """The port's 05 CLI with --features vggish on the dcase2013 fixture
    corpus writes JAX's npz tree (``features/dcase2013/vggish/fold<k>/``):
    the same files and labels, rows at the f32 gate."""
    dirs, _ = resources
    out = str(tmp_path / "port")
    rc = cli.main(["--features", "vggish", "--vggish-resources-dir", dirs["plain"], "-hs", "0.5",
                   "--device", "cpu", "dcase2013", corpus["dcase2013"], out])
    assert rc == 0
    jax_out = str(tmp_path / "jax")
    jax_datasets.generate_dcase2013_folds(
        corpus["dcase2013"], jax_out, features="vggish", hop_size=0.5, resources_dir=dirs["plain"])
    ours = _tree(os.path.join(out, "features", "dcase2013", "vggish"))
    theirs = _tree(jax_out)
    assert sorted(ours) == sorted(theirs) and len(ours) == 4
    for key, (x, y) in theirs.items():
        assert ours[key][1] == y and ours[key][0].shape == x.shape, key
        assert _cos_rows(ours[key][0], x).min() >= GATE, key
    assert os.path.exists(os.path.join(out, "features", "dcase2013", "vggish", "config_None.json"))
