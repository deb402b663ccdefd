"""The L3 audio and vision towers as PyTorch modules (port of
``l3embedding_tpu/models/towers.py``).

NCHW inside; at the public boundary the front-end output, the images and
the embedding feature maps keep the JAX package's NHWC layout, so the two
packages compare like with like. BatchNorm follows flax's (Keras's
momentum 0.99, eps 1e-3): ``train=False`` (the default) normalises with
the running statistics; ``train=True`` normalises with the batch's
biased statistics and folds them into the running ones in place (see
``_bn``). ``module.train()`` / ``.eval()`` do not choose between the two.

Parity quirks kept from the reference:
  * the embedding tap is the raw output of ``{audio,vision}_embedding_layer``,
    before its BatchNorm and ReLU (the tiny towers: the last pooled map);
  * audio max-pools are VALID (256×199 → 128×99 → 64×49 → 32×24); vision
    max-pools are SAME (2×2, then the final (28, 28));
  * vision block 1 applies ReLU *before* BatchNorm on its second conv;
  * cnn_L3_orig has no input BatchNorm in either tower.

``dtype=torch.bfloat16`` is the fast tower: parameters stay f32 and are
cast per call, convs run in bf16, and each BatchNorm computes in f32 and
rounds its output to bf16 (as flax does with f32 statistics). The tiny
towers are always f32, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from dataclasses import dataclass
from typing import Sequence

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from ..ops.bn_kernel import bn_train
from ..ops.frontend import MelConfig, SpectrogramConfig, l3_log_norm
from ..ops.mel_kernel import melspectrogram_fused
from ..ops.spec_kernel import spectrogram_fused
from ..parallel.distributed import comm_device
from ..utils import trace

BN_EPS = 1e-3
BN_MOMENTUM = 0.99
_KERNEL_DTYPES = (torch.bfloat16, torch.float32)  # bn_train's input and output types


@dataclass(frozen=True)
class ModelSplit:
    """A layer split over the mesh's model group (``parallel/tp.py`` sets it
    as the module's ``model_split``): "column" (output channels split, the
    input replicated), "gather" (a column layer whose channels are gathered
    back after it), "row" (input channels split, the output summed)."""

    kind: str
    group: object
    index: int  # this rank's model index


def model_split(layer: nn.Module) -> ModelSplit | None:
    return vars(layer).get("model_split")


def _conv_local(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    w, b = conv.weight.to(dtype), conv.bias.to(dtype)
    if dtype == torch.float32 and torch.is_grad_enabled() and conv.bias.requires_grad:
        return F.conv2d(x.to(dtype), w, None, padding=conv.padding) + b.view(1, -1, 1, 1)
    return F.conv2d(x.to(dtype), w, b, padding=conv.padding)


def _conv(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """conv(x) + bias in `dtype`. When an f32 bias takes a gradient, the bias
    is added on its own (flax's order), so that autograd sums its gradient
    with torch's reduction: the conv backward's bias sum runs one float32
    accumulator over every output position, and for a bias that feeds a
    train-mode BN (zero gradient but for rounding) it left 1.7e-2 of the
    BN's bias gradient at 8 tiny_L3 rows, against 3e-14 in a float64 step
    and 1.3e-4 in JAX.

    A conv split over the model group (``model_split``) computes this
    rank's slice: a column or gather conv takes its replicated input
    through ``_CopyToModel`` and gives its output channels (gathered back
    by ``_GatherFromModel``); a row conv's partial sum over its input
    channels is summed over the group in f32, the bias added once and the
    result rounded to `dtype` once."""
    split = model_split(conv)
    if split is None:
        return _conv_local(conv, x, dtype)
    if split.kind == "row":
        y = F.conv2d(x.to(dtype), conv.weight.to(dtype), None, padding=conv.padding)
        y = _ReduceFromModel.apply(y.float(), split.group)
        return (y + conv.bias.float().view(1, -1, 1, 1)).to(dtype)
    y = _conv_local(conv, _CopyToModel.apply(x, split.group), dtype)
    if split.kind == "gather":
        y = _GatherFromModel.apply(y, split.group)
    return y


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the input's gradient over the
    model group, in f32 (each rank's split layer gives only its channels'
    share of it)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        g = grad.float().clone()
        dist.all_reduce(g, group=ctx.group)
        return g.to(grad.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    """The sum of the ranks' partial products over the model group; the
    backward is the identity (each rank's partial product takes the whole
    gradient). Unlike ``_AllReduceSum``, whose backward sums again."""

    @staticmethod
    def forward(ctx, t, group):
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    """The ranks' channel blocks (dim 1) concatenated in model-index order;
    the backward keeps this rank's block of the gradient."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.block = slice(dist.get_rank(group) * t.shape[1], (dist.get_rank(group) + 1) * t.shape[1])
        local = t.detach().contiguous().to(comm_device(group))
        parts = [torch.empty_like(local) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, local, group=group)
        return torch.cat(parts, 1).to(t.device)

    @staticmethod
    def backward(ctx, grad):
        return grad[:, ctx.block], None


# The process group that train-mode BatchNorm takes its batch statistics
# over (``sync_batch_norm``); None: this process's batch alone.
_BN_GROUP: contextvars.ContextVar = contextvars.ContextVar("bn_group", default=None)


@contextlib.contextmanager
def sync_batch_norm(group):
    """Within the block, every train-mode BatchNorm takes its statistics over
    the global batch of `group`'s ranks (flax's BatchNorm over a sharded
    batch). A group of one, or None, leaves today's local path."""
    if group is not None and dist.get_world_size(group) == 1:
        group = None
    token = _BN_GROUP.set(group)
    try:
        yield
    finally:
        _BN_GROUP.reset(token)


class _AllReduceSum(torch.autograd.Function):
    """A sum over the group's ranks that carries the gradient back: its
    backward all-reduces the incoming gradient, so each rank's inputs get
    the share of every rank's loss."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def _all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    return _AllReduceSum.apply(t, group)


def _batch_moments(x: torch.Tensor, group) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean, biased variance) per channel of the global batch: Σx, Σx² and
    the count reduced in one all-reduce, E[x²] − E[x]² from the global sums
    (flax's fast variance under sync BN), clipped at 0."""
    c = x.shape[1]
    dims = (0, 2, 3)
    count = x.new_full((1,), x.numel() / c)
    total = _all_reduce_sum(torch.cat([x.sum(dims), (x * x).sum(dims), count]), group)
    mean = total[:c] / total[2 * c]
    var = torch.clamp(total[c:2 * c] / total[2 * c] - mean * mean, min=0.0)
    return mean, var


def _bn(bn: nn.BatchNorm2d, x: torch.Tensor, dtype: torch.dtype,
        train: bool = False) -> torch.Tensor:
    """BatchNorm computed in f32, output rounded to `dtype`.

    Train mode on the card (a bf16 or f32 CUDA tensor) is the hand-written
    kernel (``ops/bn_kernel.py::bn_train``, with its own backward), inside
    ``sync_batch_norm`` with its sums all-reduced over the group; everything
    else (the CPU, float64, eval mode) is ``_bn_f32``, the same function in
    tensor ops.

    While tracing is on (``utils/trace.py``) each call is a ``tower.bn``
    span, its casts in and out included, and in train mode its backward is
    one too: from the output's gradient to the input's (for an input that
    takes no gradient, to the per-channel scale's: in tensor ops the scale's
    and the bias's last (C,)-sized kernels fall just outside; on the kernel
    the scale is an alias of γ, whose gradient comes with the bias's)."""
    with trace.span("tower.bn", x.device):
        if train and x.is_cuda and x.dtype in _KERNEL_DTYPES and dtype in _KERNEL_DTYPES:
            scale = bn.weight.view_as(bn.weight)
            y = bn_train(x, scale, bn.bias, bn.running_mean, bn.running_var, bn.eps, BN_MOMENTUM, dtype,
                         group=_BN_GROUP.get())
        else:
            y, scale = _bn_f32(bn, x, train)
            y = y.to(dtype)
    if train:
        trace.backward_span("tower.bn", y, x if x.requires_grad else scale)
    return y


def _bn_f32(bn: nn.BatchNorm2d, x: torch.Tensor,
            train: bool) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(BatchNorm of x in f32, the per-channel scale of train mode or None).

    train=True is flax's train mode, written out in tensor ops: the batch
    mean and the biased batch variance as E[x²] − E[x]² clipped at 0
    (flax's use_fast_variance), ``(x − mean)·(rsqrt(var + eps)·scale) +
    bias``, and the running statistics updated in place as
    ``ra = 0.99·ra + 0.01·batch`` with the biased variance (torch's own
    update uses the unbiased one). This is flax's own arithmetic, so the
    port's train step follows the JAX package's leaf by leaf. Per layer
    its error against float64 is of the order of torch's fused kernel's
    (tests/test_torch_port_train.py::test_bn_train_grads_vs_float64); in a
    whole cnn_L3_melspec2 step on the CPU it is the nearer to a float64
    step, as the fused kernel's accuracy there depends on the memory
    layout (the vision input BN's bias gradient at cosine 0.99960 to
    float64, against 0.999992 written out).

    Inside ``sync_batch_norm(group)`` the statistics are the global batch's
    (``_batch_moments``); outside it, this batch's, as above. A float64
    model (the reference step of the tests) keeps float64 here.
    """
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    if not train:
        y = F.batch_norm(
            x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
            training=False, eps=bn.eps,
        )
        return y, None
    group = _BN_GROUP.get()
    if group is None:
        dims = (0, 2, 3)
        mean = x.mean(dims)
        var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
    else:
        mean, var = _batch_moments(x, group)
    with torch.no_grad():
        bn.running_mean.mul_(BN_MOMENTUM).add_(mean, alpha=1 - BN_MOMENTUM)
        bn.running_var.mul_(BN_MOMENTUM).add_(var, alpha=1 - BN_MOMENTUM)
    shape = (1, -1, 1, 1)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    y = (x - mean.view(shape)) * mul.view(shape) + bn.bias.view(shape)
    return y, mul


def same_max_pool(x: torch.Tensor, pool: Sequence[int]) -> torch.Tensor:
    """NCHW max-pool, window = stride = pool, with TF/flax SAME padding
    (the extra row or column goes to the bottom/right)."""
    pads = []
    for size, k in zip(x.shape[2:], pool):
        total = max((-(-size // k) - 1) * k + k - size, 0)
        pads.append((total // 2, total - total // 2))
    (top, bottom), (left, right) = pads
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
    return F.max_pool2d(x, tuple(pool), tuple(pool))


def nhwc_flatten(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) → (B, H·W·C) in NHWC order, f32."""
    return x.float().permute(0, 2, 3, 1).flatten(1)


@contextlib.contextmanager
def ieee_fp32(active: bool):
    """Keep f32 convs and matmuls out of TF32 on the card (the parity
    configuration matches JAX's Precision.HIGHEST); restores the caller's
    settings."""
    if not active:
        yield
        return
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


class HeInit(nn.Module):
    """A module whose conv and dense kernels start He-normal."""

    def reset_parameters(self, generator: torch.Generator) -> None:
        """He-normal (truncated at 2σ, flax's he_normal) conv and dense
        kernels from `generator`, zero biases, identity BatchNorms."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.Linear)):
                    fan_in = m.weight[0].numel()
                    std = math.sqrt(2.0 / fan_in) / 0.87962566103423978
                    nn.init.trunc_normal_(
                        m.weight, 0.0, std, -2 * std, 2 * std, generator=generator
                    )
                    m.bias.zero_()
                elif isinstance(m, nn.BatchNorm2d):
                    m.reset_parameters()


class ConvBNRelu(nn.Module):
    """3×3 SAME conv → BN → ReLU (relu_before_bn: conv → ReLU → BN)."""

    def __init__(self, in_ch: int, out_ch: int, relu_before_bn: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.bn = nn.BatchNorm2d(out_ch, eps=BN_EPS)
        self.relu_before_bn = relu_before_bn

    def forward(self, x: torch.Tensor, dtype: torch.dtype = torch.float32,
                train: bool = False) -> torch.Tensor:
        y = _conv(self.conv, x, dtype)
        if self.relu_before_bn:
            return _bn(self.bn, torch.relu(y), dtype, train)
        return torch.relu(_bn(self.bn, y, dtype, train))


class _L3Trunk(HeInit):
    """The 4-block L3 conv stack shared by the full towers: optional input
    BN, 7× ConvBNRelu (64,64 | 128,128 | 256,256 | 512) with a 2×2 pool
    after each pair, the raw embedding conv, then final BN → ReLU → pool.
    Subclasses give the input, the pools and the input BN."""

    out_dim = 512

    def __init__(self, in_ch: int, input_bn: bool, dtype: torch.dtype,
                 relu_before_bn: tuple[int, ...] = ()):
        super().__init__()
        self.dtype = dtype
        self.input_bn = nn.BatchNorm2d(in_ch, eps=BN_EPS) if input_bn else None
        widths = (64, 64, 128, 128, 256, 256, 512)
        self.blocks = nn.ModuleList(
            ConvBNRelu(i, o, relu_before_bn=k in relu_before_bn)
            for k, (i, o) in enumerate(zip((in_ch,) + widths[:-1], widths))
        )
        self.embedding_conv = nn.Conv2d(512, 512, 3, padding=1)
        self.final_bn = nn.BatchNorm2d(512, eps=BN_EPS)

    def _input(self, x: torch.Tensor) -> torch.Tensor:
        """The tower's input → NCHW f32 before the input BN."""
        raise NotImplementedError

    def _pool(self, y: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _final_pool(self, y: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _trunk(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """Input → raw embedding-conv output, NCHW in the compute dtype."""
        y = self._input(x)
        if self.input_bn is not None:
            y = _bn(self.input_bn, y, self.dtype, train)
        else:
            y = y.to(self.dtype)
        for i, block in enumerate(self.blocks):
            y = block(y, self.dtype, train)
            if i in (1, 3, 5):
                y = self._pool(y)
        return _conv(self.embedding_conv, y, self.dtype)

    def _fp32(self, x: torch.Tensor):
        return ieee_fp32(x.is_cuda and self.dtype == torch.float32)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """Input → raw embedding feature map (B, H, W, 512), NHWC, f32."""
        with self._fp32(x):
            return self._trunk(x).float().permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """Input → (B, 512) tower output: final BN, ReLU, final pool.
        train=True runs every BatchNorm in train mode (see ``_bn``)."""
        with self._fp32(x):
            y = torch.relu(_bn(self.final_bn, self._trunk(x, train), self.dtype, train))
            return nhwc_flatten(self._final_pool(y))


class L3AudioTower(_L3Trunk):
    """The 4-block L3 audio subnetwork over one of three front ends:

      'linear'    — |STFT| + L3 log norm, no input BN (cnn_L3_orig)
      'linear_db' — dB |STFT| + input BN              (cnn_L3_kapredbinputbn)
      'mel'       — dB mel (n_mels) + input BN        (cnn_L3_melspec1/2)

    The front end is a fused kernel (``spectrogram_fused`` or
    ``melspectrogram_fused``): the hand-written kernel on the card, its
    plain version on the CPU. db_batch_global=True reproduces kapre<=0.1.x's
    batch-global dB max reference.
    """

    def __init__(
        self,
        frontend_kind: str = "mel",
        n_mels: int = 128,
        final_pool: Sequence[int] = (32, 24),
        dtype: torch.dtype = torch.float32,
        db_batch_global: bool = False,
    ):
        if frontend_kind not in ("linear", "linear_db", "mel"):
            raise ValueError(f"unknown frontend_kind {frontend_kind!r}")
        super().__init__(1, input_bn=frontend_kind != "linear", dtype=dtype)
        self.frontend_kind = frontend_kind
        self.n_mels = n_mels
        self.final_pool = tuple(final_pool)
        self.db_batch_global = db_batch_global

    def frontend(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 1, n) or (B, n) PCM → (B, F, T, 1) front-end features, f32;
        a ``tower.frontend`` span while tracing is on."""
        with trace.span("tower.frontend"):
            if x.dim() == 3:
                x = x[:, 0, :]
            x = x.float().contiguous()
            fast = self.dtype == torch.bfloat16
            db_ps = not self.db_batch_global
            if self.frontend_kind == "mel":
                return melspectrogram_fused(x, MelConfig(n_mels=self.n_mels, db_per_sample=db_ps), fast)
            if self.frontend_kind == "linear":
                return l3_log_norm(spectrogram_fused(x, SpectrogramConfig(), fast))
            return spectrogram_fused(x, SpectrogramConfig(decibel=True, db_per_sample=db_ps), fast)

    def _input(self, x):
        return self.frontend(x).permute(0, 3, 1, 2)

    def _pool(self, y):
        return F.max_pool2d(y, 2)  # VALID

    def _final_pool(self, y):
        return F.max_pool2d(y, self.final_pool)


class L3VisionTower(_L3Trunk):
    """The 4-block L3 vision subnetwork: (B, 224, 224, 3) NHWC images →
    512-d. input_bn adds BatchNorm on the raw input (every type but
    cnn_L3_orig)."""

    def __init__(self, input_bn: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__(3, input_bn=input_bn, dtype=dtype, relu_before_bn=(1,))

    def _input(self, x):
        return x.float().permute(0, 3, 1, 2)

    def _pool(self, y):
        return same_max_pool(y, (2, 2))

    def _final_pool(self, y):
        return same_max_pool(y, (28, 28))


class _TinyL3(HeInit):
    """Three conv5×5 VALID (10 filters) → BN → ReLU → VALID 3×3 max-pool
    blocks, f32. The embedding feature map is the last pooled map, and
    the tower's output is that map flattened."""

    def __init__(self, in_ch: int):
        super().__init__()
        self.dtype = torch.float32
        self.convs = nn.ModuleList(nn.Conv2d(c, 10, 5) for c in (in_ch, 10, 10))
        self.bns = nn.ModuleList(nn.BatchNorm2d(10, eps=BN_EPS) for _ in range(3))

    def _input(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _trunk(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = self._input(x)
        for conv, bn in zip(self.convs, self.bns):
            y = F.max_pool2d(torch.relu(_bn(bn, _conv(conv, y, self.dtype), self.dtype, train)), 3)
        return y

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """Input → the last pooled map (B, H, W, 10), NHWC, f32."""
        with ieee_fp32(x.is_cuda):
            return self._trunk(x).permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        with ieee_fp32(x.is_cuda):
            return nhwc_flatten(self._trunk(x, train))


class TinyL3AudioTower(_TinyL3):
    """Miniature audio tower: dB |STFT| (n_dft 512, hop 240, a 480-sample
    window, VALID framing: 257×198) through the f32 spectrogram kernel,
    then the tiny blocks → 7×5×10 = 350."""

    out_dim = 350

    def __init__(self, db_batch_global: bool = False):
        super().__init__(1)
        self.db_batch_global = db_batch_global

    def frontend(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 1, n) or (B, n) PCM → (B, 257, T, 1) dB spectrogram, f32."""
        if x.dim() == 3:
            x = x[:, 0, :]
        cfg = SpectrogramConfig(
            n_dft=512, hop=240, n_win=480, padding="valid", power=1.0,
            decibel=True, db_per_sample=not self.db_batch_global,
        )
        return spectrogram_fused(x.float().contiguous(), cfg, fast=False)

    def _input(self, x):
        return self.frontend(x).permute(0, 3, 1, 2)


class TinyL3VisionTower(_TinyL3):
    """Miniature vision tower: (B, 224, 224, 3) NHWC → 6×6×10 = 360."""

    out_dim = 360

    def __init__(self):
        super().__init__(3)

    def _input(self, x):
        return x.float().permute(0, 3, 1, 2)
