"""The VGGish baseline as a PyTorch module, with its weight loader, PCA /
quantization postprocessor and a resident extractor (port of
``l3embedding_tpu/models/vggish.py``; reference
data/usc/vggish/vggish_slim.py:38-128 and vggish_postprocess.py:21-94).

(B, 96, 64) log-mel patches → [conv64, pool, conv128, pool, conv256 ×2,
pool, conv512 ×2, pool] → flatten → fc4096 ×2 → fc128, every conv 3×3 SAME
and every layer followed by ReLU, the embedding layer included (slim's
fully_connected default). The 2×2 pools divide 96 × 64 evenly, so SAME and
VALID pooling agree. NCHW inside; the last feature map is flattened in
NHWC order (H·W·C), as JAX's ``reshape`` of its (6, 4, 512) map does, so
``fc1_1`` takes the published kernel unchanged. In f32 on the card the
convs and dense layers keep TF32 off (``towers.ieee_fp32``).

Weights: an ``.npz`` with the keys ``vggish/<scope>/weights|biases`` in TF's
layouts (conv HWIO, dense (in, out)), the community export of
``vggish_model.ckpt`` that the JAX package reads; ``save_vggish_npz``
writes that layout. Without weights the extractor runs on a seeded random
init and says so.
"""

from __future__ import annotations

import logging
import math
import os

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .towers import ieee_fp32

LOGGER = logging.getLogger("l3embedding_torch.vggish")

EMBEDDING_SIZE = 128
NUM_FRAMES = 96
NUM_BANDS = 64

QUANTIZE_MIN_VAL = -2.0
QUANTIZE_MAX_VAL = +2.0

# (layer, TF-slim scope, input channels or features, output ...), in order.
CONVS = (
    ("conv1", "vggish/conv1", 1, 64),
    ("conv2", "vggish/conv2", 64, 128),
    ("conv3_1", "vggish/conv3/conv3_1", 128, 256),
    ("conv3_2", "vggish/conv3/conv3_2", 256, 256),
    ("conv4_1", "vggish/conv4/conv4_1", 256, 512),
    ("conv4_2", "vggish/conv4/conv4_2", 512, 512),
)
POOL_AFTER = ("conv1", "conv2", "conv3_2", "conv4_2")
DENSES = (
    ("fc1_1", "vggish/fc1/fc1_1", 6 * 4 * 512, 4096),
    ("fc1_2", "vggish/fc1/fc1_2", 4096, 4096),
    ("fc2", "vggish/fc2", 4096, EMBEDDING_SIZE),
)

DEFAULT_RESOURCES = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "resources", "vggish"
)


class VGGish(nn.Module):
    """The VGGish conv stack: (B, 96, 64) or (B, 96, 64, 1) → (B, 128)."""

    def __init__(self):
        super().__init__()
        self.convs = nn.ModuleDict(
            {name: nn.Conv2d(cin, cout, 3, padding=1) for name, _, cin, cout in CONVS}
        )
        self.fcs = nn.ModuleDict(
            {name: nn.Linear(fin, fout) for name, _, fin, fout in DENSES}
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        x = x.unsqueeze(1) if x.dim() == 3 else x.permute(0, 3, 1, 2)
        for name, conv in self.convs.items():
            x = torch.relu(conv(x))
            if name in POOL_AFTER:
                x = F.max_pool2d(x, 2, 2)
        x = x.permute(0, 2, 3, 1).flatten(1)  # JAX's NHWC flatten
        for fc in self.fcs.values():
            x = torch.relu(fc(x))
        return x

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's default init from `generator`: LeCun-normal kernels
        (truncated at 2σ: draws outside are drawn again), zero biases."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.Linear)):
                    w = m.weight.view(-1)
                    std = math.sqrt(1.0 / m.weight[0].numel()) / 0.87962566103423978
                    w.normal_(0.0, std, generator=generator)
                    out = torch.nonzero(w.abs() > 2 * std).squeeze(1)
                    while out.numel():
                        redraw = torch.empty(out.numel()).normal_(0.0, std, generator=generator)
                        w[out] = redraw
                        out = out[redraw.abs() > 2 * std]
                    m.bias.zero_()


def _layers(model: VGGish):
    for name, scope, _, _ in CONVS:
        yield scope, model.convs[name], "conv"
    for name, scope, _, _ in DENSES:
        yield scope, model.fcs[name], "dense"


def _to_tf(w: torch.Tensor, kind: str) -> np.ndarray:
    w = w.detach().cpu().numpy()
    return w.transpose(2, 3, 1, 0) if kind == "conv" else w.T


def _from_tf(w: np.ndarray, kind: str) -> np.ndarray:
    return w.transpose(3, 2, 0, 1) if kind == "conv" else w.T


def save_vggish_npz(path: str, model: VGGish) -> None:
    """Write the weights as ``vggish/<scope>/weights|biases`` in TF's layouts
    (the file ``load_vggish_weights`` of either package reads)."""
    tensors = {}
    for scope, layer, kind in _layers(model):
        tensors[f"{scope}/weights"] = np.ascontiguousarray(_to_tf(layer.weight, kind))
        tensors[f"{scope}/biases"] = layer.bias.detach().cpu().numpy()
    np.savez(path, **tensors)


def load_vggish_weights(path: str, model: VGGish) -> VGGish:
    """Load a ``vggish_model`` export (``.npz``, TF layouts) into `model` in
    place; → model. A TF ``.ckpt`` needs TensorFlow, which the port does not
    use: export it to ``.npz``. A missing tensor is logged and left as it
    was; a tensor of another shape raises."""
    if not path.endswith(".npz"):
        raise RuntimeError(
            f"cannot read {path}: export the TF checkpoint to .npz "
            "(keys 'vggish/<scope>/weights|biases')"
        )
    with np.load(path) as data:
        tensors = {k: data[k] for k in data.files}
    loaded = 0
    with torch.no_grad():
        for scope, layer, kind in _layers(model):
            for suffix, param in (("weights", layer.weight), ("biases", layer.bias)):
                key = f"{scope}/{suffix}"
                if key not in tensors:
                    LOGGER.warning("missing tensor %s in %s", key, path)
                    continue
                arr = _from_tf(np.asarray(tensors[key]), kind) if suffix == "weights" else tensors[key]
                if arr.shape != tuple(param.shape):
                    raise ValueError(f"shape mismatch for {key}: {arr.shape} vs {tuple(param.shape)}")
                param.copy_(torch.from_numpy(np.ascontiguousarray(arr, np.float32)))
                loaded += 1
    LOGGER.info("Loaded %d/%d VGGish tensors", loaded, 2 * (len(CONVS) + len(DENSES)))
    return model


class Postprocessor:
    """PCA whitening and uint8 quantization, on the host in numpy
    (reference vggish_postprocess.py:21-94)."""

    def __init__(self, pca_params_npz_path, pca_eigen_vectors_name="pca_eigen_vectors",
                 pca_means_name="pca_means", embedding_size=EMBEDDING_SIZE, **params):
        data = np.load(pca_params_npz_path)
        self._pca_matrix = data[pca_eigen_vectors_name]
        self._pca_means = data[pca_means_name].reshape(-1, 1)
        assert self._pca_matrix.shape == (embedding_size, embedding_size)
        assert self._pca_means.shape == (embedding_size, 1)

    def postprocess(self, embeddings_batch, embedding_size=EMBEDDING_SIZE,
                    quantize=True, quantize_min_val=QUANTIZE_MIN_VAL,
                    quantize_max_val=QUANTIZE_MAX_VAL, **params):
        assert embeddings_batch.ndim == 2
        assert embeddings_batch.shape[1] == embedding_size
        pca = np.dot(self._pca_matrix, embeddings_batch.T - self._pca_means).T
        clipped = np.clip(pca, quantize_min_val, quantize_max_val)
        if not quantize:
            return clipped
        q = (clipped - quantize_min_val) * (255.0 / (quantize_max_val - quantize_min_val))
        return q.astype(np.uint8)


class VGGishExtractor:
    """A resident VGGish on `device` ("cuda" by default), with the
    postprocessor when ``vggish_pca_params.npz`` is in `resources_dir`.

    Weights come from ``vggish_model.npz`` in `resources_dir`; without it
    the model is initialised from ``torch.Generator().manual_seed(seed)``
    and a warning says so."""

    _cache: dict = {}

    def __init__(self, resources_dir: str | None = None, device: str | torch.device = "cuda",
                 seed: int = 0):
        self.resources_dir = resources_dir or DEFAULT_RESOURCES
        self.device = torch.device(device)
        model = VGGish()
        path = os.path.join(self.resources_dir, "vggish_model.npz")
        self.has_weights = os.path.exists(path)
        if self.has_weights:
            load_vggish_weights(path, model)
        else:
            model.reset_parameters(torch.Generator().manual_seed(seed))
            LOGGER.warning(
                "VGGish weights not found in %s — running with a random init (seed %d); "
                "export vggish_model to vggish_model.npz for the pretrained baseline",
                self.resources_dir, seed,
            )
        self.model = model.to(self.device).eval()
        pca_path = os.path.join(self.resources_dir, "vggish_pca_params.npz")
        self.postprocessor = Postprocessor(pca_path) if os.path.exists(pca_path) else None

    @classmethod
    def get_cached(cls, resources_dir: str | None = None, device: str | torch.device = "cuda"):
        key = (resources_dir or DEFAULT_RESOURCES, str(torch.device(device)))
        if key not in cls._cache:
            cls._cache[key] = cls(resources_dir, device)
        return cls._cache[key]

    def embed_examples(self, examples: np.ndarray, postprocess=True) -> np.ndarray:
        """(N, 96, 64) log-mel patches → (N, 128) f32 rows (postprocessed,
        as float, when the PCA parameters are there and `postprocess`)."""
        x = torch.from_numpy(np.ascontiguousarray(examples, np.float32)).to(self.device)
        with torch.no_grad(), ieee_fp32(self.device.type == "cuda"):
            emb = self.model(x).cpu().numpy()
        if postprocess and self.postprocessor is not None:
            return self.postprocessor.postprocess(emb).astype(np.float32)
        return emb

    def embed_waveform(self, data, sample_rate, hop_size=0.96, postprocess=True) -> np.ndarray:
        from ..data.vggish_mel import waveform_to_examples

        examples = waveform_to_examples(data, sample_rate, frame_hop_sec=hop_size)
        return self.embed_examples(examples, postprocess=postprocess)

    def embed_file(self, path: str, hop_size=0.96, postprocess=True) -> np.ndarray:
        from ..data.audio_io import load_audio
        from ..data.vggish_mel import SAMPLE_RATE

        audio = load_audio(path, SAMPLE_RATE)
        # The reference pads short audio to one example window
        # (features.py:173-181).
        frame_samples = int(np.ceil(SAMPLE_RATE * max(0.96, 0.975)))
        if audio.shape[0] < frame_samples:
            pad = frame_samples - audio.shape[0]
            audio = np.pad(audio, (pad // 2, pad - pad // 2), mode="constant")
        return self.embed_waveform(audio, SAMPLE_RATE, hop_size=hop_size, postprocess=postprocess)
