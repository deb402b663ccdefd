"""Post-training int8 audio-embedding extraction (port of
``l3embedding_tpu/embed/quantized.py``).

The recipe is the JAX package's, on the port's towers:

  * BatchNorm folding: at inference each conv→BN pair is one conv with
    w' = w·γ/√(var+ε) and b' = (b−mean)·γ/√(var+ε) + β, folded in numpy in
    the JAX package's dtype and order, so the folded weights come out equal.
    The embedding conv (the raw tap) is left unfolded.
  * Per-output-channel symmetric int8 weights (scale = amax/127).
  * Static per-tensor symmetric activation scales from a calibration pass
    (amax, or a percentile, of each conv input over representative windows),
    so each requantize fuses into the previous conv's epilogue and
    activations stay int8 from the first conv to the embedding conv.
  * 2×2 max-pools taken on the int8 tensors: the epilogue is monotone
    non-decreasing, so pool-then-requantize equals requantize-then-pool;
    the conv kernel takes them in its epilogue (``conv3x3_s8(pool=True)``).

On the card every conv is the hand-written kernel of
``ops/int8_conv_kernel.py`` (``csrc/int8_conv.cu``: s8 × s8 → s32 with the
epilogue fused); on the CPU its plain version. The front end is the int8
DFT (``ops/frontend.melspectrogram_int8dft``, mel towers, the default) or the
bf16 front-end kernel (``mel_kernel`` / ``spec_kernel``). Calibration, as in
the JAX package, runs the folded f32 tower on the bf16 front end even when
the int8 DFT serves; ``embedding_cosine`` measures the int8 rows against the
folded f32 tower on the f32 front end, and ``calibrate_files`` gates on it.

Artifacts (``save_artifact`` / ``load_artifact``) are the JAX package's npz
format, byte for byte in names and dtypes, so either package loads the
other's; reading one needs only numpy.
"""

from __future__ import annotations

import json
import logging
import math
import os
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..compat.from_jax import from_jax_variables
from ..models.embedding import _pool_flatten
from ..models.registry import build_model
from ..models.towers import L3AudioTower, ieee_fp32
from ..ops.frontend import MelConfig, SpectrogramConfig, l3_log_norm, melspectrogram_int8dft
from ..ops.int8_conv_kernel import conv3x3_s8, pack_weights
from ..ops.mel_kernel import melspectrogram_fused
from ..ops.spec_kernel import spectrogram_fused
from ..training.checkpoints import load_variables
from .extract import INIT_SEED, EmbeddingExtractor, frame_uniform, replica_devices

LOGGER = logging.getLogger("l3embedding_torch.embed")


class IntEightAccuracyError(RuntimeError):
    """Raised when the measured int8-vs-f32 cosine misses the gate."""


# Blocks (of the 7 conv-BN-ReLU blocks) followed by a 2×2 VALID pool.
_POOL_AFTER = (1, 3, 5)


@dataclass
class _FoldedTower:
    """BN-folded f32 audio tower: 7 conv (w HWIO, b) + the raw embedding
    conv, as numpy; convs and emb_conv are None for a tower loaded from an
    artifact (front-end description only)."""

    frontend_kind: str  # 'linear' | 'linear_db' | 'mel'
    n_mels: int
    input_affine: tuple | None  # (a, c): y = fe·a + c (the folded input BN)
    convs: list | None
    emb_conv: tuple | None
    db_batch_global: bool = False
    _on_device: dict = field(default_factory=dict, repr=False, compare=False)

    def frontend_cfg(self):
        if self.frontend_kind == "mel":
            return MelConfig(n_mels=self.n_mels, db_per_sample=not self.db_batch_global)
        return SpectrogramConfig(decibel=self.frontend_kind == "linear_db",
                                 db_per_sample=not self.db_batch_global)

    def tensors(self, device: torch.device) -> dict:
        """The folded arrays as f32 tensors on `device` (convs OIHW), made
        once a device."""
        key = str(device)
        if key not in self._on_device:
            put = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)  # noqa: E731
            out = {"affine": None if self.input_affine is None else tuple(map(put, self.input_affine))}
            if self.convs is not None:
                out["convs"] = [(put(w.transpose(3, 2, 0, 1)), put(b)) for w, b in self.convs + [self.emb_conv]]
            self._on_device[key] = out
        return self._on_device[key]


def _fold_bn(w, b, scale, bias, mean, var, eps=1e-3):
    s = scale / np.sqrt(var + eps)
    return w * s, (b - mean) * s + bias


def fold_audio_tower(tower: nn.Module, model_type: str, db_batch_global: bool = False) -> _FoldedTower:
    """Fold every conv→BN pair of a port ``L3AudioTower`` (its parameters
    and running statistics, f32) into plain convs, in numpy."""
    if not isinstance(tower, L3AudioTower):
        raise ValueError(
            f"int8 quantization supports the full L3 audio towers; "
            f"{model_type!r} uses {type(tower).__name__}"
        )
    sd = {k: v.detach().cpu().numpy() for k, v in tower.state_dict().items()}

    def bn(prefix):
        return tuple(sd[f"{prefix}.{k}"] for k in ("weight", "bias", "running_mean", "running_var"))

    def hwio(prefix):
        return np.ascontiguousarray(sd[f"{prefix}.weight"].transpose(2, 3, 1, 0)), sd[f"{prefix}.bias"]

    input_affine = None
    if tower.frontend_kind != "linear":
        scale, bias, mean, var = bn("input_bn")
        a = scale / np.sqrt(var + 1e-3)
        input_affine = (a, bias - mean * a)
    convs = [_fold_bn(*hwio(f"blocks.{i}.conv"), *bn(f"blocks.{i}.bn")) for i in range(7)]
    return _FoldedTower(
        frontend_kind=tower.frontend_kind,
        n_mels=tower.n_mels,
        input_affine=input_affine,
        convs=convs,
        emb_conv=hwio("embedding_conv"),
        db_batch_global=db_batch_global,
    )


def _frontend_features(fold: _FoldedTower, audio: torch.Tensor, f32: bool, dft_int8: bool = False,
                       affine=None) -> torch.Tensor:
    """(B, n) PCM → (B, freq, T, 1) f32 features with the folded input BN
    (`affine`, tensors on audio's device). dft_int8 runs the int8 DFT (mel
    front ends only); else the front-end kernel, f32 or bf16."""
    cfg = fold.frontend_cfg()
    audio = audio.float().contiguous()
    if dft_int8:
        if fold.frontend_kind != "mel":
            raise ValueError(
                "dft_int8 front-end exists for mel front-ends only "
                f"(got {fold.frontend_kind!r})"
            )
        y = melspectrogram_int8dft(audio, cfg)
    elif fold.frontend_kind == "mel":
        y = melspectrogram_fused(audio, cfg, fast=not f32)
    else:
        y = spectrogram_fused(audio, cfg, fast=not f32)
    if fold.frontend_kind == "linear":
        y = l3_log_norm(y)
    if affine is not None:
        a, c = affine
        y = y * a + c
    return y


def percentile(a: torch.Tensor, p: float) -> torch.Tensor:
    """The p-th percentile of all of a's values with linear interpolation
    (numpy's and JAX's default), from the k largest or smallest values
    rather than a full sort."""
    flat = a.reshape(-1).float()
    n = flat.numel()
    pos = p / 100.0 * (n - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, n - 1)
    w = pos - lo
    if n - lo <= hi + 1:  # the upper tail is the shorter
        top = torch.topk(flat, n - lo, largest=True, sorted=True).values
        v_lo, v_hi = top[n - 1 - lo], top[n - 1 - hi]
    else:
        bottom = torch.topk(flat, hi + 1, largest=False, sorted=True).values
        v_lo, v_hi = bottom[lo], bottom[hi]
    return v_lo * (1.0 - w) + v_hi * w


@torch.no_grad()
def folded_forward(fold: _FoldedTower, audio: torch.Tensor, pool, *, f32_frontend: bool = True,
                   collect_amax: bool = False, collect_pct: float | None = None):
    """BN-folded f32 reference forward on audio's device. Returns the
    embeddings; with collect_amax=True also the 8 per-conv-input amax values
    that calibration uses (7 blocks + the embedding conv), and with
    collect_pct=P also their P-th percentiles of |activations|."""
    if audio.dim() == 3:
        audio = audio[:, 0, :]
    t = fold.tensors(audio.device)
    amaxes, pcts = [], []

    def observe(y):
        a = y.abs()
        amaxes.append(a.amax())
        if collect_pct is not None:
            pcts.append(percentile(a, collect_pct))

    with ieee_fp32(audio.is_cuda):
        y = _frontend_features(fold, audio, f32=f32_frontend, affine=t["affine"]).permute(0, 3, 1, 2)
        for i, (w, b) in enumerate(t["convs"][:7]):
            observe(y)
            y = torch.clamp(F.conv2d(y, w, padding=1) + b[:, None, None], min=0.0)
            if i in _POOL_AFTER:
                y = F.max_pool2d(y, 2)
        observe(y)
        w, b = t["convs"][7]
        feat = F.conv2d(y, w, padding=1) + b[:, None, None]
    emb = _pool_flatten(feat.permute(0, 2, 3, 1), pool)
    if collect_pct is not None:
        return emb, torch.stack(amaxes), torch.stack(pcts)
    if collect_amax:
        return emb, torch.stack(amaxes)
    return emb


class QuantizedTower(nn.Module):
    """The int8 tower on one device: (B, 1, n) or (B, n) PCM → (B, dim) f32.

    Front end (+ the folded input BN) → quantize at act_scales[0] → 7 int8
    convs with the requant epilogue (blocks 1, 3 and 5 with the 2×2 int8
    pool in the same call) → the embedding conv with the dequant epilogue →
    the embedding pool. Its
    buffers hold the packed int8 weights, their scales and biases, the
    activation scales and deq[i] = act_scales[i]·wscale[i] (f32)."""

    def __init__(self, fold: _FoldedTower, pool, wq, wscale, biases, dft_int8: bool):
        super().__init__()
        self.fold = fold
        self.pool = tuple(pool)
        self.dft_int8 = bool(dft_int8)
        f32 = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
        for i, (w, s, b) in enumerate(zip(wq, wscale, biases)):
            self.register_buffer(f"w{i}", pack_weights(np.asarray(w, np.int8)))
            self.register_buffer(f"wscale{i}", f32(s))
            self.register_buffer(f"bias{i}", f32(b))
            self.register_buffer(f"deq{i}", torch.zeros(len(s)))
        self.register_buffer("act_scales", torch.zeros(8))
        if fold.input_affine is not None:
            self.register_buffer("affine_a", f32(fold.input_affine[0]))
            self.register_buffer("affine_c", f32(fold.input_affine[1]))

    @torch.no_grad()
    def set_act_scales(self, scales) -> None:
        self.act_scales.copy_(torch.from_numpy(np.asarray(scales, np.float32)))
        for i in range(8):
            getattr(self, f"deq{i}").copy_(self.act_scales[i] * getattr(self, f"wscale{i}"))

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 3:
            x = x[:, 0, :]
        affine = (self.affine_a, self.affine_c) if self.fold.input_affine is not None else None
        y = _frontend_features(self.fold, x, f32=False, dft_int8=self.dft_int8, affine=affine)
        s = self.act_scales
        q = torch.clamp(torch.round(y / s[0]), -127, 127).to(torch.int8).contiguous()
        for i in range(7):
            q = conv3x3_s8(q, getattr(self, f"w{i}"), getattr(self, f"deq{i}"),
                           getattr(self, f"bias{i}"), s[i + 1 : i + 2], pool=i in _POOL_AFTER)
        feat = conv3x3_s8(q, self.w7, self.deq7, self.bias7)
        return _pool_flatten(feat, self.pool)


class _WindowRunner(EmbeddingExtractor):
    """EmbeddingExtractor's dispatch (pinned uploads, the device split,
    EmbeddingRows) over prebuilt towers, without bucket padding: a batch
    pads only to a multiple of the device count, as the JAX package's
    QuantizedAudioEmbedder.embed_windows does over a mesh."""

    def __init__(self, towers, replicas, devices, sr: int = 48000):
        self._bind(towers, replicas, devices, None, None, sr, False)

    def _bucket_size(self, n: int) -> int:
        k = len(self._replicas)
        return -(-n // k) * k


class QuantizedAudioEmbedder:
    """Int8 counterpart of EmbeddingExtractor.embed_windows (audio only).

        q = QuantizedAudioEmbedder(weights_path, 'cnn_L3_melspec2', 'short')
        q.calibrate(representative_windows)   # (N, 48000) float32
        emb = q.embed_windows(windows)

    weights_path: a ``.ckpt`` of the JAX package; `variables` (flax layout,
    numpy, as ``training.checkpoints.load_variables`` returns) instead of a
    file; neither gives the seeded random tower of EmbeddingExtractor.
    devices: the JAX package's ``mesh``: the int8 tower on each, every batch
    split over them (under db_batch_global the first only). dft_int8: run
    the front end's DFT s8 × s8 → s32 (mel front ends only); None chooses it
    for mel front ends, False keeps the bf16 front-end kernel.
    `embedding_cosine(windows)` reports min/mean cosine against the folded
    f32 tower for gating.
    """

    def __init__(self, weights_path: str | None, model_type: str, pooling_type: str = "short",
                 db_batch_global: bool = False, variables=None, devices=None,
                 dft_int8: bool | None = None, device: str | torch.device = "cuda"):
        spec = build_model(model_type)
        pool = spec.audio_embedding_pooling[pooling_type]
        tower = spec.audio_tower()
        if variables is None and weights_path is not None:
            variables = load_variables(weights_path)
        if variables is None:
            tower.reset_parameters(torch.Generator().manual_seed(INIT_SEED))
        else:
            tower.load_state_dict(from_jax_variables(variables, model_type))
        fold = fold_audio_tower(tower, model_type, db_batch_global)

        # Per-output-channel symmetric weight quantization.
        wq, wscale = [], []
        for w, _ in fold.convs + [fold.emb_conv]:
            ws = np.maximum(np.abs(w).max(axis=(0, 1, 2)), 1e-12) / 127.0
            wq.append(np.clip(np.round(w / ws), -127, 127).astype(np.int8))
            wscale.append(np.asarray(ws, np.float32))
        biases = [np.asarray(b, np.float32) for _, b in fold.convs + [fold.emb_conv]]
        dft = fold.frontend_kind == "mel" if dft_int8 is None else bool(dft_int8)
        self._setup(fold, pool, wq, wscale, biases, None, devices, dft, device)

    def _setup(self, fold, pool, wq, wscale, biases, act_scales, devices, dft_int8, device):
        self.fold = fold
        self.pool = pool
        self.dft_int8 = bool(dft_int8)
        self._wq, self._wscale, self._biases = list(wq), list(wscale), list(biases)
        self.devices, self._replicas = replica_devices(devices, device, fold.db_batch_global)
        self.towers = [QuantizedTower(fold, pool, wq, wscale, biases, self.dft_int8).to(d)
                       for d in self._replicas]
        self._runner = _WindowRunner(self.towers, self._replicas, self.devices)
        self._act_scales = None
        if act_scales is not None:
            self._set_scales(act_scales)

    def _set_scales(self, scales) -> None:
        self._act_scales = np.asarray(scales, np.float32)
        for tower in self.towers:
            tower.set_act_scales(self._act_scales)

    @classmethod
    def _from_quantized(cls, fold, pool, wq, wscale, biases, act_scales, devices=None,
                        dft_int8: bool = False, device: str | torch.device = "cuda"):
        """Rebuild an embedder from already-quantized arrays (the artifact
        path: no f32 checkpoint, no calibration). `fold` carries only the
        front-end description, so calibrate() and embedding_cosine() refuse."""
        self = object.__new__(cls)
        self._setup(fold, pool, wq, wscale, biases, act_scales, devices, dft_int8, device)
        return self

    def _require_reference_tower(self, what: str):
        if self.fold.convs is None:
            raise RuntimeError(
                f"{what} needs the BN-folded f32 reference tower, which "
                "an int8 artifact does not carry (the accuracy gate was "
                "measured at export and rides in the artifact metadata). "
                "Rebuild from the f32 checkpoint to recalibrate/regate."
            )

    # -- calibration ---------------------------------------------------
    def calibrate(self, windows: np.ndarray, batch_size: int = 128,
                  method: str = "amax", percentile: float = 99.99):
        """Set static activation scales from representative windows:
        method='amax' clips at the observed absolute maximum, 'percentile'
        at the given percentile of |activations| (the larger over the
        calibration batches). Runs the folded f32 tower on the bf16 front
        end, on the first device. Returns the per-conv-input amax."""
        if method not in ("amax", "percentile"):
            raise ValueError(f"unknown calibration method {method!r}")
        self._require_reference_tower("calibrate()")
        dev = self._replicas[0]
        amax, pct = None, None
        for i in range(0, len(windows), batch_size):
            chunk = torch.from_numpy(np.ascontiguousarray(windows[i:i + batch_size], np.float32)).to(dev)
            if method == "percentile":
                _, a, p = folded_forward(self.fold, chunk, self.pool, f32_frontend=False,
                                         collect_pct=float(percentile))
                p = p.cpu().numpy()
                pct = p if pct is None else np.maximum(pct, p)
            else:
                _, a = folded_forward(self.fold, chunk, self.pool, f32_frontend=False, collect_amax=True)
            a = a.cpu().numpy()
            amax = a if amax is None else np.maximum(amax, a)
        clip = pct if method == "percentile" else amax
        self._set_scales(np.maximum(clip, 1e-12) / 127.0)
        return np.asarray(amax)

    # -- inference -----------------------------------------------------
    def embed_windows_async(self, windows):
        """Dispatch (N, 48000) windows without synchronising; returns an
        EmbeddingRows handle (``result()`` gives the rows)."""
        if self._act_scales is None:
            raise RuntimeError(
                "QuantizedAudioEmbedder.calibrate(windows) must run before "
                "embed_windows — static int8 scales come from calibration"
            )
        return self._runner.embed_windows_async(windows)

    def embed_windows(self, windows: np.ndarray) -> np.ndarray:
        return self.embed_windows_async(windows).result()

    # -- gating --------------------------------------------------------
    def embedding_cosine(self, windows: np.ndarray):
        """Min/mean cosine of int8 embeddings vs the BN-folded f32 tower
        (f32 front end) on `windows`."""
        self._require_reference_tower("embedding_cosine()")
        x = np.asarray(windows, np.float32)
        got = self.embed_windows(x)
        audio = torch.from_numpy(np.ascontiguousarray(x)).to(self._replicas[0])
        want = folded_forward(self.fold, audio, self.pool, f32_frontend=True).cpu().numpy()
        num = (got * want).sum(axis=1)
        den = np.linalg.norm(got, axis=1) * np.linalg.norm(want, axis=1)
        cos = num / np.maximum(den, 1e-12)
        return float(cos.min()), float(cos.mean())


class QuantizedEmbeddingExtractor(EmbeddingExtractor):
    """File-level int8 extractor with EmbeddingExtractor's interface
    (embed_windows / embed_audio / embed_file, the same framing, buckets,
    device framing and `devices` split), for the `05 --int8` path.

    Call ``calibrate_files(paths)`` once with a handful of representative
    files (or load an artifact) before extraction; the scales are then
    frozen, so features do not depend on file order (the bucket's zero
    padding is exact under symmetric quantization).
    """

    ARTIFACT_FORMAT = "l3embedding_tpu-int8-artifact"  # the JAX package's format key
    ARTIFACT_VERSION = 1

    def __init__(self, weights_path: str | None, model_type: str, pooling_type: str = "original",
                 sr: int = 48000, db_batch_global: bool = False, variables=None, devices=None,
                 device_framing: bool = False, dft_int8: bool | None = None,
                 device: str | torch.device = "cuda"):
        self.q = QuantizedAudioEmbedder(
            weights_path, model_type, pooling_type, db_batch_global=db_batch_global,
            variables=variables, devices=devices, dft_int8=dft_int8, device=device,
        )
        self._bind_common(sr, model_type, pooling_type, device_framing)

    def _bind_common(self, sr, model_type, pooling_type, device_framing, calib_cosine=None):
        """Shared tail of __init__ and load_artifact."""
        q = self.q
        self._bind(q.towers, q._replicas, q.devices, model_type, pooling_type, int(sr), device_framing)
        self.calib_cosine = calib_cosine  # (min, mean) from calibration

    def calibrate_files(self, paths, hop_size: float = 0.1, method: str = "amax",
                        percentile: float = 99.99, min_cosine: float | None = 0.999,
                        gate_windows: int = 256):
        """Calibrate static int8 scales and measure the accuracy gate.

        After the scales are set, the int8 tower's min/mean cosine against
        the BN-folded f32 tower is measured on (up to `gate_windows` of) the
        calibration windows, logged and kept in `self.calib_cosine`. Below a
        `min_cosine` that is not None, IntEightAccuracyError is raised."""
        from ..data.audio_io import load_audio

        windows = [frame_uniform(load_audio(p, self.sr), self.sr, hop_size) for p in paths]
        allw = np.concatenate(windows)
        amax = self.q.calibrate(allw, method=method, percentile=percentile)
        LOGGER.info(
            "int8 calibration (%s) over %d files (%d windows); amax per "
            "conv input: %s", method, len(paths), len(allw),
            np.array2string(amax, precision=3),
        )
        # An evenly sampled subset keeps the gate O(seconds) while still
        # spanning every calibration file.
        step = max(1, len(allw) // gate_windows)
        gate_set = allw[::step][:gate_windows]
        cmin, cmean = self.q.embedding_cosine(gate_set)
        self.calib_cosine = (cmin, cmean)
        LOGGER.info(
            "int8 vs folded-f32 cosine on %d calibration windows: "
            "min %.6f mean %.6f (gate %s)", len(gate_set), cmin, cmean,
            "none" if min_cosine is None else f"{min_cosine:g}",
        )
        if min_cosine is not None and cmin < min_cosine:
            raise IntEightAccuracyError(
                f"int8 tower measured min cosine {cmin:.6f} vs the "
                f"BN-folded f32 tower on {len(gate_set)} calibration "
                f"windows — below the required {min_cosine:g}. Try "
                f"method='percentile' calibration, more representative "
                f"calibration files, or override the gate explicitly "
                f"(--int8-min-cosine 0 disables it)."
            )
        return self.calib_cosine

    def embed_windows_async(self, windows):
        if self.q._act_scales is None:
            raise RuntimeError(
                "QuantizedAudioEmbedder.calibrate(windows) must run before "
                "embed_windows — static int8 scales come from calibration"
            )
        return super().embed_windows_async(windows)

    def embed_audio_async(self, audio: np.ndarray, hop_size: float = 0.1,
                          device_framing: bool | None = None):
        if self.q._act_scales is None:
            raise RuntimeError(
                "calibrate_files(paths) must run before embed_audio — "
                "static int8 scales come from calibration"
            )
        return super().embed_audio_async(audio, hop_size, device_framing)

    # -- deployment artifact --------------------------------------------
    def save_artifact(self, path: str) -> None:
        """Export the calibrated int8 tower as one self-contained .npz (the
        JAX package's format): the 8 per-channel int8 convs (HWIO) with their
        scales and folded biases, the static activation scales, the folded
        input BN, the front-end description and the measured calibration
        cosine. Written atomically (tmp + rename)."""
        q = self.q
        if q._act_scales is None:
            raise RuntimeError(
                "calibrate_files() must run before save_artifact — the "
                "artifact freezes calibrated scales"
            )
        arrays = {}
        for i in range(8):
            arrays[f"wq_{i}"] = np.asarray(q._wq[i], np.int8)
            arrays[f"wscale_{i}"] = np.asarray(q._wscale[i], np.float32)
            arrays[f"bias_{i}"] = np.asarray(q._biases[i], np.float32)
        arrays["act_scales"] = np.asarray(q._act_scales, np.float32)
        if q.fold.input_affine is not None:
            arrays["input_affine_a"] = np.asarray(q.fold.input_affine[0])
            arrays["input_affine_c"] = np.asarray(q.fold.input_affine[1])
        cmin, cmean = self.calib_cosine if self.calib_cosine is not None else (None, None)
        meta = {
            "format": self.ARTIFACT_FORMAT,
            "version": self.ARTIFACT_VERSION,
            "model_type": self.model_type,
            "pooling_type": self.pooling_type,
            "sr": int(self.sr),
            "frontend_kind": q.fold.frontend_kind,
            "n_mels": int(q.fold.n_mels),
            "db_batch_global": bool(q.fold.db_batch_global),
            "calib_cosine_min": cmin,
            "calib_cosine_mean": cmean,
            # The gate was measured with this front end: a loader reproduces it.
            "dft_int8": bool(q.dft_int8),
        }
        arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
        LOGGER.info(
            "saved int8 artifact %s (%s/%s, measured min cosine %s)",
            path, self.model_type, self.pooling_type,
            "unrecorded" if cmin is None else f"{cmin:.6f}",
        )

    @classmethod
    def load_artifact(cls, path: str, devices=None, device_framing: bool = False,
                      min_cosine: float | None = 0.999, device: str | torch.device = "cuda"):
        """Rebuild a serving-ready extractor from save_artifact output (of
        either package): no f32 checkpoint, no calibration. `min_cosine`
        re-checks the gate recorded at export (IntEightAccuracyError below
        it; None skips). An artifact without the dft_int8 key runs the bf16
        front end it was gated with."""
        with np.load(path) as z:
            meta = json.loads(bytes(z["meta_json"].tobytes()).decode())
            if meta.get("format") != cls.ARTIFACT_FORMAT:
                raise ValueError(f"{path} is not an int8 artifact")
            if int(meta.get("version", 0)) > cls.ARTIFACT_VERSION:
                raise ValueError(
                    f"{path} is artifact version {meta['version']}; this "
                    f"build reads <= {cls.ARTIFACT_VERSION}"
                )
            wq = [z[f"wq_{i}"] for i in range(8)]
            wscale = [z[f"wscale_{i}"] for i in range(8)]
            biases = [z[f"bias_{i}"] for i in range(8)]
            act_scales = z["act_scales"]
            input_affine = ((z["input_affine_a"], z["input_affine_c"])
                            if "input_affine_a" in z else None)
        cmin = meta.get("calib_cosine_min")
        if min_cosine is not None:
            if cmin is None:
                raise IntEightAccuracyError(
                    f"{path} records no calibration cosine; pass "
                    "min_cosine=None to load it ungated"
                )
            if cmin < min_cosine:
                raise IntEightAccuracyError(
                    f"{path} recorded min cosine {cmin:.6f} at export — "
                    f"below the required {min_cosine:g}. Re-export with "
                    "better calibration or override the gate explicitly."
                )
        spec = build_model(meta["model_type"])
        fold = _FoldedTower(
            frontend_kind=meta["frontend_kind"],
            n_mels=int(meta["n_mels"]),
            input_affine=input_affine,
            convs=None,
            emb_conv=None,
            db_batch_global=bool(meta["db_batch_global"]),
        )
        self = object.__new__(cls)
        self.q = QuantizedAudioEmbedder._from_quantized(
            fold, spec.audio_embedding_pooling[meta["pooling_type"]], wq, wscale, biases, act_scales,
            devices=devices, dft_int8=bool(meta.get("dft_int8", False)), device=device,
        )
        self._bind_common(
            meta["sr"], meta["model_type"], meta["pooling_type"], device_framing,
            calib_cosine=None if cmin is None else (float(cmin), float(meta["calib_cosine_mean"])),
        )
        return self
