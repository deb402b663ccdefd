"""Plain PyTorch reference of the L3 audio-visual correspondence model.

Written from the published description (Arandjelovic and Zisserman, ICCV
2017; Cramer et al., ICASSP 2019) and the reference repository's
``l3embedding/audio_model.py`` / ``vision_model.py`` / ``model.py``, in plain
tensor operations. It imports nothing of the program under test and takes
nothing that the program made: the weights are the harness's, made from
the seed, and every table (DFT bank, mel filterbank) is worked out here
from ``dsp.py``.

* Front ends: frames cut from the PCM (TF-SAME padding for mel, VALID for
  linear), a product with the periodic-Hann-windowed DFT bank, the power
  spectrum; mel: the HTK/Slaney filterbank product, the amplitude, dB
  referenced to each window's max and floored at -80 dB; linear: the
  amplitude, ``log(max(x, 1e-12)) / 5``.
* Towers: an input BatchNorm (not cnn_L3_orig), seven 3x3 SAME convs with
  BatchNorm and ReLU (the vision tower's second block applies ReLU before
  its BatchNorm), 2x2 max-pools after the second, fourth and sixth (VALID
  for audio, SAME for vision), the 512-wide embedding conv; its raw output
  is the embedding map. The tower's output adds the final BatchNorm, ReLU
  and the final max-pool.
* The AVC head: concat(vision, audio), Dense(128), ReLU, Dense(2).
* Training: BatchNorm in train mode over the batch (biased variance, the
  running statistics moved by 1 - momentum), softmax cross-entropy with
  soft labels plus ``weight_decay * sum(w^2)`` over conv and dense kernels,
  and Adam written out.

Layout: NCHW inside; conv kernels (out, in, 3, 3), dense kernels (out, in).

``prec`` is the arithmetic of every conv and matmul: "f32" (IEEE float32,
TF32 off), "tf32" (TF32 on), "fp8" (each operand rounded to float8 e4m3
with one scale a tensor, gradients to e5m2, float32 accumulation) or
"int8" (operands and gradients rounded to symmetric int8 with one scale a
tensor). The reference runs in "f32"; the others are the controls that a
lower precision must fail.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import dsp

PRECISIONS = ("f32", "tf32", "fp8", "int8")
E4M3_MAX = 448.0
E5M2_MAX = 57344.0


@contextlib.contextmanager
def precision(prec: str):
    """TF32 on for "tf32", off otherwise, for convs and matmuls; restores."""
    if prec not in PRECISIONS:
        raise ValueError(f"unknown precision {prec!r}")
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = prec == "tf32"
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def _round_fp8(x: torch.Tensor, dtype: torch.dtype, vmax: float) -> torch.Tensor:
    """x rounded to the fp8 type `dtype` under one scale (amax / vmax), back
    in x's type."""
    s = x.detach().abs().amax().clamp(min=1e-30) / vmax
    return (x / s).to(dtype).to(x.dtype) * s


def e4m3(x):
    return _round_fp8(x, torch.float8_e4m3fn, E4M3_MAX)


def e5m2(x):
    return _round_fp8(x, torch.float8_e5m2, E5M2_MAX)


def int8(x):
    """x rounded to symmetric int8 under one scale (amax / 127), back in
    x's type."""
    s = x.detach().abs().amax().clamp(min=1e-30) / 127.0
    return torch.clamp(torch.round(x / s), -127, 127) * s


class _LowConv(torch.autograd.Function):
    """3x3 SAME conv on operands rounded by `fwd`; the backward rounds the
    gradient by `bwd` and takes it against the same rounded operands."""

    @staticmethod
    def forward(ctx, x, w, fwd, bwd):
        qx, qw = fwd(x), fwd(w)
        ctx.save_for_backward(qx, qw)
        ctx.bwd = bwd
        return F.conv2d(qx, qw, None, padding=1)

    @staticmethod
    def backward(ctx, g):
        qx, qw = ctx.saved_tensors
        qg = ctx.bwd(g)
        gx = torch.nn.grad.conv2d_input(qx.shape, qw, qg, padding=1) if ctx.needs_input_grad[0] else None
        gw = torch.nn.grad.conv2d_weight(qx, qw.shape, qg, padding=1) if ctx.needs_input_grad[1] else None
        return gx, gw, None, None


class _LowLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, fwd, bwd):
        qx, qw = fwd(x), fwd(w)
        ctx.save_for_backward(qx, qw)
        ctx.bwd = bwd
        return qx @ qw.t()

    @staticmethod
    def backward(ctx, g):
        qx, qw = ctx.saved_tensors
        qg = ctx.bwd(g)
        return qg @ qw, qg.t() @ qx, None, None


# Operand and gradient rounding of the lower-precision controls.
_LOW = {"fp8": (e4m3, e5m2), "int8": (int8, int8)}


def conv(x, kernel, bias, prec):
    if prec in _LOW:
        return _LowConv.apply(x, kernel, *_LOW[prec]) + bias.view(1, -1, 1, 1)
    return F.conv2d(x, kernel, bias, padding=1)


def dense(x, kernel, bias, prec):
    if prec in _LOW:
        return _LowLinear.apply(x, kernel, *_LOW[prec]) + bias
    return x @ kernel.t() + bias


def matmul(a, b, prec):
    if prec in _LOW:
        low = _LOW[prec][0]
        return low(a) @ low(b)
    return a @ b


# ---------------------------------------------------------------- front ends


@functools.lru_cache(maxsize=None)
def _bank(n_dft: int, device: str) -> tuple[torch.Tensor, torch.Tensor]:
    real, imag = dsp.stft_basis(n_dft)
    return (torch.from_numpy(real.astype(np.float32)).to(device),
            torch.from_numpy(imag.astype(np.float32)).to(device))


@functools.lru_cache(maxsize=None)
def _melfb(sr: int, n_dft: int, n_mels: int, fmin: float, htk: bool, device: str) -> torch.Tensor:
    fb = dsp.mel_filterbank(sr, n_dft, n_mels, fmin, None, htk)
    return torch.from_numpy(fb.T.astype(np.float32)).to(device)


def _power(pcm: torch.Tensor, a: dict, prec: str) -> torch.Tensor:
    """(B, n) → (B, T, n_dft/2 + 1) power spectrum."""
    x = pcm.float()
    if a["padding"] == "same":
        left, right = dsp.same_pad_amounts(x.shape[-1], a["n_dft"], a["hop"])
        x = F.pad(x, (left, right))
    frames = x.unfold(-1, a["n_dft"], a["hop"])
    real, imag = _bank(a["n_dft"], str(x.device))
    re, im = matmul(frames, real, prec), matmul(frames, imag, prec)
    return re * re + im * im


def frontend(pcm: torch.Tensor, cfg: dict, prec: str = "f32") -> torch.Tensor:
    """(B, n) or (B, 1, n) PCM in [-1, 1] → (B, 1, F, T) features."""
    if pcm.dim() == 3:
        pcm = pcm[:, 0]
    a = cfg["audio"]
    p = _power(pcm, a, prec)
    if a["frontend"] == "mel":
        fb = _melfb(cfg["sr"], a["n_dft"], a["n_mels"], a["fmin"], a["htk"], str(pcm.device))
        amp = torch.sqrt(torch.clamp(matmul(p, fb, prec), min=0.0))
        db = 10.0 * torch.log10(torch.clamp(amp, min=a["amin"]))
        db = db - db.amax(dim=(1, 2), keepdim=True)
        feat = torch.clamp(db, min=-a["dynamic_range"])
    elif a["frontend"] == "linear":
        amp = p ** (a["power"] / 2.0)
        feat = torch.log(torch.clamp(amp, min=a["log_eps"])) / a["log_div"]
    else:
        raise ValueError(f"unknown front end {a['frontend']!r}")
    return feat.transpose(1, 2)[:, None]


# ---------------------------------------------------------------- parameters


def _tower_specs(prefix: str, in_ch: int, input_bn: bool, cfg: dict) -> list[tuple]:
    k = cfg["kernel_size"]
    specs = []

    def bn(name, c):
        specs.extend((f"{prefix}.{name}.{leaf}", (c,), leaf, None) for leaf in ("scale", "offset", "mean", "var"))

    def cv(name, cin, cout):
        specs.append((f"{prefix}.{name}.kernel", (cout, cin, k, k), "kernel", cin * k * k))
        specs.append((f"{prefix}.{name}.bias", (cout,), "bias", None))

    if input_bn:
        bn("bn_in", in_ch)
    c = in_ch
    for i, w in enumerate(cfg["widths"]):
        cv(f"conv{i}", c, w)
        bn(f"bn{i}", w)
        c = w
    cv("emb", c, cfg["embedding_width"])
    bn("bn_out", cfg["embedding_width"])
    return specs


def param_specs(cfg: dict, parts=("vision", "audio", "head")) -> list[tuple]:
    """(name, shape, kind, fan_in) of every leaf of `parts`; kind is
    "kernel", "out_kernel" (the output layer's), "bias", "scale", "offset",
    "mean" or "var"."""
    specs = []
    if "vision" in parts:
        specs += _tower_specs("vision", cfg["vision"]["input"][2], cfg["vision"]["input_bn"], cfg)
    if "audio" in parts:
        specs += _tower_specs("audio", 1, cfg["audio"]["input_bn"], cfg)
    if "head" in parts:
        width = 2 * cfg["embedding_width"]
        hidden, classes = cfg["head"]["layer_size"], cfg["head"]["classes"]
        specs += [("head.fc1.kernel", (hidden, width), "kernel", width), ("head.fc1.bias", (hidden,), "bias", None),
                  ("head.fc2.kernel", (classes, hidden), "out_kernel", hidden),
                  ("head.fc2.bias", (classes,), "bias", None)]
    return specs


def is_running_stat(name: str) -> bool:
    return name.endswith((".mean", ".var"))


# ---------------------------------------------------------------- towers


def _bn_eval(x, p, name, eps):
    shape = (1, -1, 1, 1)
    inv = torch.rsqrt(p[f"{name}.var"] + eps)
    return (x - p[f"{name}.mean"].view(shape)) * (inv * p[f"{name}.scale"]).view(shape) + p[f"{name}.offset"].view(shape)


def _pool2(x, same: bool):
    if same:
        return same_max_pool(x, (2, 2))
    return F.max_pool2d(x, 2)


def same_max_pool(x: torch.Tensor, pool) -> torch.Tensor:
    """Max-pool, window = stride = pool, TF SAME padding (the extra row or
    column at the bottom or right)."""
    pads = []
    for size, k in zip(x.shape[2:], pool):
        total = max((-(-size // k) - 1) * k + k - size, 0)
        pads.append((total // 2, total - total // 2))
    (top, bottom), (left, right) = pads
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
    return F.max_pool2d(x, tuple(pool), tuple(pool))


def _block_eval(x, p, prefix, i, relu_first, pool, same, eps, prec):
    y = conv(x, p[f"{prefix}.conv{i}.kernel"], p[f"{prefix}.conv{i}.bias"], prec)
    if relu_first:
        y = _bn_eval(torch.relu(y), p, f"{prefix}.bn{i}", eps)
    else:
        y = torch.relu(_bn_eval(y, p, f"{prefix}.bn{i}", eps))
    return _pool2(y, same) if pool else y


def embedding_map(p: dict, prefix: str, x: torch.Tensor, cfg: dict, prec: str = "f32") -> torch.Tensor:
    """Inference: the tower's input (NCHW) → the raw embedding-conv output,
    BatchNorms on their running statistics."""
    t = cfg[prefix]
    eps = cfg["bn_eps"]
    if t["input_bn"]:
        x = _bn_eval(x, p, f"{prefix}.bn_in", eps)
    same = t["pool"] == "same"
    for i in range(len(cfg["widths"])):
        x = _block_eval(x, p, prefix, i, i in t.get("relu_before_bn", []), i in cfg["pool_after"], same, eps, prec)
    return conv(x, p[f"{prefix}.emb.kernel"], p[f"{prefix}.emb.bias"], prec)


def audio_embedding(p: dict, pcm: torch.Tensor, cfg: dict, pooling: str, prec: str = "f32") -> torch.Tensor:
    """(B, n) PCM windows → (B, dim) embeddings: the raw embedding map,
    SAME max-pooled by the pooling's size, flattened in (H, W, C) order."""
    with precision(prec):
        feat = embedding_map(p, "audio", frontend(pcm, cfg, prec), cfg, prec)
        pooled = same_max_pool(feat, cfg["audio"]["embedding_pooling"][pooling])
        return pooled.permute(0, 2, 3, 1).flatten(1)


def frame_windows(audio: np.ndarray, sr: int, hop_size: float) -> np.ndarray:
    """A clip → its (n, sr) 1 s windows, as the reference's
    ``l3embedding/features.py`` frames them: a clip shorter than a window is
    zero-padded around it to one window; a longer one is cut every hop from
    its start, and a trailing part shorter than a hop is dropped."""
    hop = int(hop_size * sr)
    if len(audio) < sr:
        pad = sr - len(audio)
        audio = np.pad(audio, (pad // 2, pad - pad // 2))
    n = (len(audio) - sr) // hop + 1
    idx = np.arange(n)[:, None] * hop + np.arange(sr)[None, :]
    return np.asarray(audio, dtype=np.float32)[idx]


# ---------------------------------------------------------------- training
#
# A batch in train mode is a list of row blocks ("parts"), each on a device
# of its own, in row order: one part on one device, or the global batch of a
# data-parallel cell spread over the cards of the run, so that its float32
# activations fit. The parts are one batch: every BatchNorm takes its
# statistics over all of their rows, and the loss is the mean over all of
# them. The leaves live on the first part's device ("home").
#
# Each unit (an input BatchNorm, or a conv, its BatchNorm, ReLU and pool) is
# computed a part at a time, in two regions that are recomputed in the
# backward (activation checkpointing), each on its part's device alone: the
# first gives the part's sums of the BatchNorm's input and of its square,
# the second, given the batch's statistics, the part's output. Only the
# statistics, a number a channel, cross devices.


def _to(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return t.to(x.device)


def _checkpoint(fn, *args):
    # No step of the reference draws random numbers: nothing to replay.
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


def _bn_input(x, kernel, bias, relu_first, prec):
    """A unit's BatchNorm input: x itself (an input BatchNorm), else the
    conv's output, after a ReLU where the unit applies it first."""
    if kernel is None:
        return x
    y = conv(x, kernel, bias, prec)
    return torch.relu(y) if relu_first else y


def _sums(x, kernel, bias, relu_first, prec):
    z = _bn_input(x, kernel, bias, relu_first, prec)
    return z.sum(dim=(0, 2, 3)), (z * z).sum(dim=(0, 2, 3))


def _unit_out(x, kernel, bias, relu_first, mean, mul, offset, tail, prec):
    z = _bn_input(x, kernel, bias, relu_first, prec)
    shape = (1, -1, 1, 1)
    y = (z - mean.view(shape)) * mul.view(shape) + offset.view(shape)
    return tail(y)


def _unit(parts, kernel, bias, scale, offset, eps, relu_first, tail, prec):
    """→ (each part's output, batch mean, biased batch variance) of one unit
    over the batch's parts; the statistics on the first part's device."""
    home = parts[0].device
    # Values a channel: a 3x3 SAME conv keeps the spatial size.
    count = sum(x.shape[0] * x.shape[2] * x.shape[3] for x in parts)
    s1 = s2 = 0.0
    for x in parts:
        a, b = _checkpoint(_sums, x, kernel if kernel is None else _to(kernel, x),
                           bias if bias is None else _to(bias, x), relu_first, prec)
        s1, s2 = s1 + a.to(home), s2 + b.to(home)
    mean = s1 / count
    var = torch.clamp(s2 / count - mean * mean, min=0.0)
    mul = torch.rsqrt(var + eps) * scale
    outs = [_checkpoint(_unit_out, x, kernel if kernel is None else _to(kernel, x),
                        bias if bias is None else _to(bias, x), relu_first,
                        _to(mean, x), _to(mul, x), _to(offset, x), tail, prec) for x in parts]
    return outs, mean, var


def tower_train(p: dict, prefix: str, parts: list, cfg: dict, prec: str, stats: dict) -> list:
    """Train mode: the input's parts (NCHW) → their (rows, 512) outputs,
    every BatchNorm over the whole batch (biased variance as E[x²] − E[x]²,
    clipped at 0); each BatchNorm's (mean, variance) goes to stats[name]."""
    t = cfg[prefix]
    eps = cfg["bn_eps"]
    same = t["pool"] == "same"
    if t["input_bn"]:
        n = f"{prefix}.bn_in"
        parts, *stats[n] = _unit(parts, None, None, p[f"{n}.scale"], p[f"{n}.offset"], eps, False,
                                 _identity, prec)
    for i in range(len(cfg["widths"])):
        c, n = f"{prefix}.conv{i}", f"{prefix}.bn{i}"
        relu_first = i in t.get("relu_before_bn", [])
        tail = functools.partial(_block_tail, relu=not relu_first, pool=i in cfg["pool_after"], same=same)
        parts, *stats[n] = _unit(parts, p[f"{c}.kernel"], p[f"{c}.bias"], p[f"{n}.scale"], p[f"{n}.offset"],
                                 eps, relu_first, tail, prec)
    n = f"{prefix}.bn_out"
    tail = functools.partial(_out_tail, final_pool=tuple(t["final_pool"]), same=same)
    parts, *stats[n] = _unit(parts, p[f"{prefix}.emb.kernel"], p[f"{prefix}.emb.bias"], p[f"{n}.scale"],
                             p[f"{n}.offset"], eps, False, tail, prec)
    return parts


def _identity(y):
    return y


def _block_tail(y, relu: bool, pool: bool, same: bool):
    y = torch.relu(y) if relu else y
    return _pool2(y, same) if pool else y


def _out_tail(y, final_pool, same: bool):
    y = torch.relu(y)
    y = same_max_pool(y, final_pool) if same else F.max_pool2d(y, final_pool)
    return y.permute(0, 2, 3, 1).flatten(1)


def preprocess(batch: dict, devices: list) -> tuple[list, list, list]:
    """Storage types → model inputs, cut into one part a device in row
    order: frames uint8 → 2·(v/255) − 1 (NCHW), PCM int16 → a/32768,
    labels float32."""
    b = int(batch["label"].shape[0])
    if b % len(devices):
        raise ValueError(f"a batch of {b} rows does not split over {len(devices)} devices")
    rows = b // len(devices)
    video, audio, labels = [], [], []
    for i, d in enumerate(devices):
        sl = slice(i * rows, (i + 1) * rows)
        v = torch.as_tensor(batch["video"][sl]).to(d).float()
        video.append((2.0 * (v / 255.0) - 1.0).permute(0, 3, 1, 2))
        audio.append(torch.as_tensor(batch["audio"][sl]).to(d).float() / 32768.0)
        labels.append(torch.as_tensor(batch["label"][sl]).to(d).float())
    return video, audio, labels


def avc_loss(p: dict, batch: dict, cfg: dict, prec: str, stats: dict, devices: list,
             outs: dict | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """→ (cross-entropy + L2 term, cross-entropy) of one train-mode forward
    over the batch's rows spread over `devices`; `outs`, where given, gets
    each tower's output rows (on the host)."""
    home = devices[0]
    video, audio, labels = preprocess(batch, devices)
    with torch.no_grad():
        feat = [frontend(a, cfg, prec) for a in audio]
    towers = {"vision": tower_train(p, "vision", video, cfg, prec, stats),
              "audio": tower_train(p, "audio", feat, cfg, prec, stats)}
    if outs is not None:
        outs.update({k: torch.cat([x.detach().cpu() for x in v]) for k, v in towers.items()})
    total, rows = 0.0, 0
    for v, a, lab in zip(towers["vision"], towers["audio"], labels):
        y = torch.cat([v, a], dim=-1)
        y = torch.relu(dense(y, _to(p["head.fc1.kernel"], y), _to(p["head.fc1.bias"], y), prec))
        logits = dense(y, _to(p["head.fc2.kernel"], y), _to(p["head.fc2.bias"], y), prec)
        total = total + (-(lab * torch.log_softmax(logits, dim=-1)).sum()).to(home)
        rows += lab.shape[0]
    ce = total / rows
    l2 = sum(torch.sum(v * v) for k, v in p.items() if k.endswith(".kernel"))
    return ce + cfg["weight_decay"] * l2, ce


def train_steps(params: dict, batches: list[dict], cfg: dict, prec: str = "f32", devices=None) -> dict:
    """Adam steps from `params` (not changed), one a batch, each batch's
    rows spread over `devices` (default: the leaves' device) → {"loss":
    [each step's cross-entropy + L2], "grad1": {leaf: the first step's
    gradient}, "emb1": {tower: its output rows in the first step},
    "params": {leaf: every leaf after the last step, running statistics
    included}}, on the leaves' device (emb1 on the host)."""
    opt = cfg["adam"]
    lr, b1, b2, eps = opt["learning_rate"], opt["b1"], opt["b2"], opt["eps"]
    momentum = cfg["bn_momentum"]
    home = next(iter(params.values())).device
    devices = [torch.device(d) for d in devices] if devices else [home]
    if devices[0] != home:
        raise ValueError("the first device holds the leaves")
    p = {k: v.detach().clone() for k, v in params.items()}
    trainable = [k for k in p if not is_running_stat(k)]
    m = {k: torch.zeros_like(p[k]) for k in trainable}
    v = {k: torch.zeros_like(p[k]) for k in trainable}
    losses, grad1, emb1 = [], None, {}
    with precision(prec):
        for t, batch in enumerate(batches, 1):
            leaves = {k: p[k].requires_grad_(not is_running_stat(k)) for k in p}
            stats: dict = {}
            loss, _ = avc_loss(leaves, batch, cfg, prec, stats, devices, emb1 if t == 1 else None)
            grads = torch.autograd.grad(loss, [leaves[k] for k in trainable])
            losses.append(float(loss.detach()))
            with torch.no_grad():
                if grad1 is None:
                    grad1 = {k: g.clone() for k, g in zip(trainable, grads)}
                for k, g in zip(trainable, grads):
                    m[k].mul_(b1).add_(g, alpha=1 - b1)
                    v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    mhat = m[k] / (1 - b1 ** t)
                    vhat = v[k] / (1 - b2 ** t)
                    p[k] = p[k].detach() - lr * mhat / (torch.sqrt(vhat) + eps)
                for name, (mean, var) in stats.items():
                    p[f"{name}.mean"] = momentum * p[f"{name}.mean"].detach() + (1 - momentum) * mean.detach()
                    p[f"{name}.var"] = momentum * p[f"{name}.var"].detach() + (1 - momentum) * var.detach()
            del leaves, grads, loss, stats
    return {"loss": losses, "grad1": grad1, "emb1": emb1, "params": {k: x.detach() for k, x in p.items()}}
