"""The port's VGGish on the card against the same weights on the CPU.

No JAX here, so that the file collects on a machine with a card and
without flax. Run there with ``python -m pytest
tests/test_torch_port_vggish_card.py -m cuda``.
"""

import os

import numpy as np
import pytest
import torch

from l3embedding_torch.data.vggish_mel import waveform_to_examples
from l3embedding_torch.models import vggish


@pytest.fixture(scope="module")
def resources(tmp_path_factory):
    """A seeded vggish_model.npz and seeded PCA parameters (on a machine
    with a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    root = str(tmp_path_factory.mktemp("vggish_card"))
    model = vggish.VGGish()
    model.reset_parameters(torch.Generator().manual_seed(3))
    vggish.save_vggish_npz(os.path.join(root, "vggish_model.npz"), model)
    rng = np.random.RandomState(33)
    q, _ = np.linalg.qr(rng.randn(128, 128))
    np.savez(os.path.join(root, "vggish_pca_params.npz"), pca_eigen_vectors=q * 40.0,
             pca_means=np.zeros(128))
    return root


def _examples(n):
    t = np.arange(int(16000 * (0.96 * n + 0.1))) / 16000
    rng = np.random.RandomState(4)
    x = 0.3 * np.sin(2 * np.pi * 440.0 * t * (1 + 0.2 * np.sin(t))) + 0.05 * rng.randn(t.size)
    return waveform_to_examples(x, 16000)[:n]


@pytest.mark.cuda
def test_card_rows_match_cpu_with_tf32_off(resources):
    """64 examples: rows at cosine >= 0.9999 against the CPU copy although
    torch's TF32 defaults are on (the extractor keeps it off itself);
    postprocessed uint8 rows within one level."""
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        card = vggish.VGGishExtractor(resources, device="cuda")
        cpu = vggish.VGGishExtractor(resources, device="cpu")
        ex = _examples(64)
        a, b = card.embed_examples(ex, postprocess=False), cpu.embed_examples(ex, postprocess=False)
        a, b = a.astype(np.float64), b.astype(np.float64)
        cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1) + 1e-30)
        assert a.shape == (64, 128) and cos.min() >= 0.9999, cos.min()
        assert np.abs(card.embed_examples(ex) - cpu.embed_examples(ex)).max() <= 1
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.cuda
def test_extractor_defaults_to_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    ex = vggish.VGGishExtractor(str(tmp_path))
    assert ex.device.type == "cuda" and next(ex.model.parameters()).is_cuda
