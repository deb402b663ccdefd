"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): builds the four
kernel sources (mel and linear spectrogram front ends, block-1 conv and
GEMM probe, the int8 conv) from this checkout, one nvcc each and all at
once, holds each of the five kernels against its plain PyTorch version
(the int8 conv at every conv shape of the cnn_L3_melspec2 int8 tower and
at its three pooled calls; its wgmma kernels' SASS must show integer
wgmma fed by TMA),
then drives the
port's paths end to end through their user entry points: embedding
extraction for all five model types (cnn_L3_melspec2 and cnn_L3_orig at
full width in f32 and bf16), the AVC forward of all five at batch 8,
get_audio_embedding and get_image_embedding, each against a CPU copy of
the same weights, and the block-1 probe tool
(``l3embedding_torch.tools.block1_spike all``) at batch 128; the block-1
library's SASS must show wgmma fed by TMA and no mma.sync. Then the
serving side on cnn_L3_melspec2 at full width, f32 and bf16: extraction
from files (device framing against host framing, bytes uploaded and time
per file, the file API and CLI) and the service, stream and HTTP server
(latency percentiles and clips/s under 1, 16 and 64 closed-loop clients).
Then the training side (phase_train) on cnn_L3_melspec2 at full width, f32
and bf16: the port's epoch cycle (train steps, eval steps, the four
checkpoint roles, the history files; through train() on an h5 corpus where
h5py is installed, else on the same batches in memory), the trained
checkpoint loaded into EmbeddingExtractor, one step against the same step
on a CPU copy, 10 steps on one batch whose loss must fall, and the step
time, pairs/s, peak memory and a profile at batch 64. Then the AVC sample
factory (phase_sample): the port's 01 and 02 sampling on a seeded corpus of
24 ten-second clips (the native host library built beside the kernels),
every batch checked, samples/s in one process (native and numpy
augmentation, none) and in 4, the native augmentation against numpy,
cnn_L3_melspec2 trained in f32 and bf16 on the factory's stream (steps/s,
data wait, idle share), and phase_train's state through directory
checkpoints, bit for bit. Then int8 extraction
(phase_int8) on cnn_L3_melspec2: calibration, the gate against the folded
f32 tower, artifacts, embed_file, the CPU port, the HTTP server on
--int8-artifact and windows/s beside bf16 and f32; and the 05 corpus CLI
(phase_corpus) on a dcase2013 corpus of 40 WAVs in f32, bf16, int8 and from
the int8 artifact. Then data-parallel training (phase_ddp) on
cnn_L3_melspec2 at full width: two ranks on the card through gloo, and one
rank per card through NCCL where several cards are visible, launched with
torch.distributed.run (``l3embedding_torch.tools.dp_check``), held against
one process on the whole batch (f32, bf16, per_replica), with the epoch
cycle, the chief's writes and a preemption raised on rank 1 alone; tensor
parallelism (phase_tp): the same launcher with the state split over a
model axis of 2 (two ranks on the card over gloo, a rank per card over
NCCL on 2 and 4 cards), the f32, bf16 and accumulated steps held against
one process, each rank's slices against the checkpoint the ranks gathered,
that checkpoint in EmbeddingExtractor, bytes a rank and ms a step beside
pure data parallelism; and the
VGGish baseline (phase_vggish): the card against a CPU copy, examples/s and
the 05 CLI with --features vggish on the 40 WAVs. Last, the downstream
classifier (phase_classify, stage 06's MLP): classifier/train.py::train_mlp
on seeded features at UrbanSound8K's scale (8,732 clips × 31 rows × 6144,
3 epochs at batch 64: s/epoch, rows/s, peak memory, the idle share of an
epoch, the file-level test accuracy), the MLP on the card against the CPU
from one start, and phase_corpus's f32 features through train_mlp (05 →
06); train() and the 06 CLI too where sklearn is installed.
Fixtures are made at run time in a temporary directory (stdlib WAV,
``.npy`` image, ``.npz`` video, h5 corpus, the factory's ``.npy`` clips) or
in memory (the classifier's features); nothing is downloaded.

    python3 chip_smoke.py

Exits nonzero, with no result line, when no CUDA device is present or a
phase fails. The last line of stdout is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}};
the line before it is the kernels table (times measured in this run,
bounds computed from this run's shapes, launches counted over the main
paths' runs only).
"""

from __future__ import annotations

import copy
import io
import json
import os
import statistics
import subprocess
import sys
import time
from collections import Counter, defaultdict
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# H100 SXM data-sheet peaks (dense), for the kernels' bounds.
PEAK_BF16_TC = 989e12
PEAK_FP32 = 67e12
PEAK_HBM = 3.35e12

BATCH = 64  # a BUCKETS size
AVC_BATCH = 8  # as __graft_entry__.entry()
MODEL_TYPES = ("cnn_L3_orig", "cnn_L3_kapredbinputbn", "cnn_L3_melspec1",
               "cnn_L3_melspec2", "tiny_L3")
# Kernel launches on the main paths, by "{kernel}_{bf16|f32}".
MAIN_PATH_LAUNCHES: Counter = Counter()


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int = 20) -> float:
    """Host time to issue one call of fn (no synchronisation inside the
    timed loop): the wrapper's own cost per call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / iters


def row_cosines(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = a.flatten(1).double(), b.flatten(1).double()
    return (a * b).sum(1) / (a.norm(dim=1) * b.norm(dim=1) + 1e-30)


def fft_frame_flops(n_dft: int) -> float:
    """Operations the f32 kernels' real FFT runs on one frame, as
    csrc/fft_stage.cuh schedules it (a multiply or an add counts one): the
    window (n_dft products); the complex FFT of M = n_dft/2 points, whose
    first pass has no twiddles (radix 2 when log2 M is odd: 4 per
    butterfly; else radix 4: 16) and whose later radix-4 passes take three
    twiddle products a butterfly (34); the real post-pass with the power,
    24 per pair of bins (k, M − k), k = 1…M/2, and 4 for bins 0 and M."""
    m = n_dft // 2
    log2m = m.bit_length() - 1
    if log2m % 2:
        first, later = 4 * (m // 2), (log2m - 1) // 2
    else:
        first, later = 16 * (m // 4), log2m // 2 - 1
    return float(n_dft + first + later * 34 * (m // 4) + 24 * (m // 2) + 4)


def mel_bound_ms(batch, n, cfg, fast: bool) -> tuple[float, str, str]:
    """Least time for the function at these shapes, with the count of the
    algorithm that runs: the operations at their unit's peak or the bytes it
    must move (PCM and tables in, features out) at the HBM rate, whichever is
    larger. bf16 counts the DFT product over the kernel's n_dft basis
    columns (tensor cores) and the sparse mel sum, 2 per CSR weight (FP32
    pipes), units that work at the same time, so the larger of the two; f32
    counts the real FFT and the sparse mel sum, both on the FP32 pipes."""
    from l3embedding_torch.ops import dft_stage, fft_stage

    t = cfg.n_frames(n)
    ptr, lo, w = fft_stage.mel_csr(cfg.sr, cfg.n_dft, cfg.n_mels, cfg.fmin, cfg.fmax, cfg.htk)
    mel_flops = batch * t * 2.0 * w.size
    if fast:
        seg_ptr, segs = dft_stage.mel_segments(ptr, lo, cfg.n_dft)
        dft_flops = 2.0 * batch * t * cfg.n_dft * cfg.n_dft
        ops_s = max(dft_flops / PEAK_BF16_TC, mel_flops / PEAK_FP32)
        table_bytes = cfg.n_dft * cfg.n_dft * 2 + seg_ptr.nbytes + segs.nbytes + w.nbytes
        count = "bf16 DFT product over n_dft columns + sparse mel"
    else:
        ops_s = (batch * t * fft_frame_flops(cfg.n_dft) + mel_flops) / PEAK_FP32
        table_bytes = 2 * cfg.n_dft * 4 + cfg.n_dft * 4 + ptr.nbytes + lo.nbytes + w.nbytes
        count = "f32 real FFT + sparse mel"
    bytes_ = batch * n * 4 + table_bytes + batch * cfg.n_mels * t * 4
    bound_by = "operations" if ops_s * PEAK_HBM > bytes_ else "bytes"
    return max(ops_s, bytes_ / PEAK_HBM) * 1e3, bound_by, count


def library_melspec(x, cfg, window, mel_t):
    """One cuFFT STFT + mel matmul + per-sample dB: the yardstick, timed
    only here; the port never calls it."""
    from l3embedding_torch.ops import dsp_ref
    from l3embedding_torch.ops.frontend import amplitude_to_db

    left, right = dsp_ref.same_pad_amounts(x.shape[-1], cfg.n_dft, cfg.hop)
    xp = torch.nn.functional.pad(x, (left, right))
    spec = torch.stft(xp, cfg.n_dft, cfg.hop, window=window, center=False, return_complex=True)
    m = torch.matmul(spec.abs().square().transpose(1, 2), mel_t)
    return amplitude_to_db(torch.sqrt(m).transpose(1, 2)[..., None])


def check_block_shapes(dev, n_frames: int) -> None:
    """The bf16 kernels take 128 frames a block at B = 64 and 64 at the AVC
    forward's B = 8 (dft_stage.frames_per_block), so that the checks at
    those two batches cover both block shapes the sources build."""
    from l3embedding_torch.ops import dft_stage

    shapes = {b: dft_stage.frames_per_block(b, n_frames, str(torch.device(dev))) for b in (BATCH, AVC_BATCH)}
    log(f"bf16 frames per block at {n_frames} frames: {shapes}")
    if shapes != {BATCH: 128, AVC_BATCH: 64}:
        raise SystemExit(f"expected 128 frames a block at B={BATCH} and 64 at B={AVC_BATCH}, got {shapes}")


def phase_kernel(dev):
    from l3embedding_torch.ops import dsp_ref, mel_kernel
    from l3embedding_torch.ops.frontend import MelConfig, amplitude_to_db, mel_matrix_f32

    rng = np.random.RandomState(0)
    pcm = (rng.randn(BATCH, 48000) * 0.3 * rng.uniform(0.01, 1.0, (BATCH, 1))).astype(np.float32)
    x = torch.from_numpy(pcm).to(dev)
    x8 = x[:AVC_BATCH].contiguous()
    check_block_shapes(dev, 199)
    results = {}
    for fast in (True, False):
        cos_gate, db_gate = (0.9999, 0.1) if fast else (0.999999, 0.01)
        for xb in (x, x8):  # B = 64 and the AVC forward's B = 8 (another bf16 block shape)
            batch = xb.shape[0]
            for n_mels in (256, 128):
                for decibel in (True, False):
                    cfg = MelConfig(n_mels=n_mels, decibel=decibel)
                    got = mel_kernel.melspectrogram_fused(xb, cfg, fast=fast)
                    want = mel_kernel.melspectrogram_fused_ref(xb, cfg, fast=fast)
                    torch.cuda.synchronize()
                    assert got.shape == want.shape == (batch, n_mels, 199, 1), got.shape
                    assert torch.isfinite(got).all()
                    cos = row_cosines(got, want).min().item()
                    gd, wd = (got, want) if decibel else (amplitude_to_db(got), amplitude_to_db(want))
                    mean_db = (gd - wd).abs().mean().item()
                    max_abs = (got - want).abs().max().item()
                    log(f"kernel fast={fast} B={batch} n_mels={n_mels} decibel={decibel}: "
                        f"min cosine {cos:.9f} (> {cos_gate}), mean |d| {mean_db:.6f} dB "
                        f"(< {db_gate}), max |d| {max_abs:.6g}")
                    if not (cos > cos_gate and mean_db < db_gate):
                        raise SystemExit(f"kernel disagrees with its plain version (fast={fast}, B={batch})")
                    if batch == BATCH and n_mels == 256 and decibel:
                        results[fast] = {"max_abs_err": max_abs}

        cfg = MelConfig(n_mels=256)
        window = torch.from_numpy(dsp_ref.periodic_hann(cfg.n_dft).astype(np.float32)).to(dev)
        mel_t = torch.from_numpy(mel_matrix_f32(cfg.sr, cfg.n_dft, 256, cfg.fmin, cfg.fmax, cfg.htk)).to(dev)
        lib = library_melspec(x, cfg, window, mel_t)
        ref = mel_kernel.melspectrogram_fused_ref(x, cfg, fast=False)
        assert row_cosines(lib, ref).min().item() > 0.9999
        ms = cuda_ms(lambda: mel_kernel.melspectrogram_fused(x, cfg, fast=fast))
        plain_ms = cuda_ms(lambda: mel_kernel.melspectrogram_fused_ref(x, cfg, fast=fast), iters=5)
        library_ms = cuda_ms(lambda: library_melspec(x, cfg, window, mel_t))
        kernel_graph_ms = graph_ms(lambda: mel_kernel.melspectrogram_fused(x, cfg, fast=fast))
        library_graph_ms = graph_ms(lambda: library_melspec(x, cfg, window, mel_t))
        wrapper_ms = host_ms(lambda: mel_kernel.melspectrogram_fused(x, cfg, fast=fast))
        b8_ms = cuda_ms(lambda: mel_kernel.melspectrogram_fused(x8, cfg, fast=fast))
        b8_graph_ms = graph_ms(lambda: mel_kernel.melspectrogram_fused(x8, cfg, fast=fast))
        bound_ms, bound_by, count = mel_bound_ms(BATCH, 48000, cfg, fast)
        mode = "bf16" if fast else "f32"
        log(f"mel_frontend {mode} B={BATCH} n_mels=256: kernel {ms:.4f} ms per call back to back "
            f"(CUDA events); {kernel_graph_ms:.4f} ms in CUDA-graph replay; wrapper host time "
            f"{wrapper_ms:.4f} ms a call")
        log(f"mel_frontend {mode} B={AVC_BATCH} n_mels=256: kernel {b8_ms:.4f} ms (CUDA events); "
            f"{b8_graph_ms:.4f} ms in graph replay")
        log(f"mel_frontend {mode} B={BATCH} n_mels=256: plain {plain_ms:.4f} ms")
        log(f"mel_frontend {mode} B={BATCH} n_mels=256: library (torch.stft+matmul+dB) {library_ms:.4f} ms "
            f"(CUDA events); {library_graph_ms:.4f} ms in graph replay")
        log(f"mel_frontend {mode} B={BATCH} n_mels=256: bound {bound_ms:.4f} ms ({bound_by}; count: {count})")
        results[fast].update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                             bound_ms=bound_ms, bound_by=bound_by, graph_ms=kernel_graph_ms,
                             library_graph_ms=library_graph_ms, host_ms=wrapper_ms,
                             b8_ms=b8_ms, b8_graph_ms=b8_graph_ms)
    return results


def spec_bound_ms(batch, n, cfg, fast: bool) -> tuple[float, str, str]:
    """Least time for the linear front end at these shapes, with the count
    of the algorithm that runs: the operations at their unit's peak (bf16:
    the DFT product over the kernel's n_dft basis columns on the tensor
    cores; f32: the real FFT on the FP32 pipes) or the bytes it must move
    (PCM and tables in, |STFT| out) at the HBM rate, whichever is larger."""
    t = cfg.n_frames(n)
    if fast:
        ops_s = 2.0 * batch * t * cfg.n_dft * cfg.n_dft / PEAK_BF16_TC
        table_bytes, count = cfg.n_dft * cfg.n_dft * 2, "bf16 DFT product over n_dft columns"
    else:
        ops_s = batch * t * fft_frame_flops(cfg.n_dft) / PEAK_FP32
        table_bytes, count = 2 * cfg.n_dft * 4 + cfg.n_dft * 4, "f32 real FFT"
    bytes_ = batch * n * 4 + table_bytes + batch * cfg.n_freq * t * 4
    bound_by = "operations" if ops_s * PEAK_HBM > bytes_ else "bytes"
    return max(ops_s, bytes_ / PEAK_HBM) * 1e3, bound_by, count


def library_spec(x, cfg, window):
    """One cuFFT STFT magnitude, the linear front end's yardstick, timed only
    here; the port never calls it."""
    spec = torch.stft(x, cfg.n_dft, cfg.hop, win_length=cfg.n_dft, window=window,
                      center=False, return_complex=True)
    return spec.abs()[..., None]


def phase_spec_kernel(dev):
    """The linear-spectrogram kernel against its plain version in the three
    configurations the model types use (cnn_L3_orig amplitude, kapredbinputbn
    dB, tiny dB with a 480-sample window), both operand types, both dB modes;
    then its times at the orig configuration."""
    from l3embedding_torch.ops import dsp_ref, spec_kernel
    from l3embedding_torch.ops.frontend import SpectrogramConfig, amplitude_to_db

    rng = np.random.RandomState(3)
    pcm = (rng.randn(BATCH, 48000) * 0.3 * rng.uniform(0.01, 1.0, (BATCH, 1))).astype(np.float32)
    pcm[1, 10000:30000] = 0.0  # a silent stretch: bins at the amin floor
    x = torch.from_numpy(pcm).to(dev)
    x8 = x[:AVC_BATCH].contiguous()
    check_block_shapes(dev, 197)
    tiny = dict(n_dft=512, hop=240, n_win=480)
    cases = [
        ("orig", SpectrogramConfig()),
        ("kapredbinputbn", SpectrogramConfig(decibel=True)),
        ("kapredbinputbn batch-global", SpectrogramConfig(decibel=True, db_per_sample=False)),
        ("tiny", SpectrogramConfig(decibel=True, **tiny)),
        ("tiny batch-global", SpectrogramConfig(decibel=True, db_per_sample=False, **tiny)),
    ]
    results = {}
    for fast in (True, False):
        cos_gate, db_gate = (0.9999, 0.1) if fast else (0.999999, 0.01)
        for xb in (x, x8):  # B = 64 and the AVC forward's B = 8 (another bf16 block shape)
            batch = xb.shape[0]
            for name, cfg in cases:
                got = spec_kernel.spectrogram_fused(xb, cfg, fast=fast)
                want = spec_kernel.spectrogram_fused_ref(xb, cfg, fast=fast)
                torch.cuda.synchronize()
                assert got.shape == want.shape == (batch, 257, cfg.n_frames(48000), 1), got.shape
                assert torch.isfinite(got).all()
                cos = row_cosines(got, want).min().item()
                gd, wd = (got, want) if cfg.decibel else (amplitude_to_db(got), amplitude_to_db(want))
                mean_db = (gd - wd).abs().mean().item()
                max_abs = (got - want).abs().max().item()
                log(f"spec kernel fast={fast} B={batch} {name}: min cosine {cos:.9f} (> {cos_gate}), "
                    f"mean |d| {mean_db:.6f} dB (< {db_gate}), max |d| {max_abs:.6g}")
                if not (cos > cos_gate and mean_db < db_gate):
                    raise SystemExit(f"spec kernel disagrees with its plain version (fast={fast}, B={batch}, {name})")
                if batch == BATCH and name == "orig":
                    results[fast] = {"max_abs_err": max_abs}

        cfg = SpectrogramConfig()
        window = torch.from_numpy(dsp_ref.periodic_hann(cfg.n_dft).astype(np.float32)).to(dev)
        lib = library_spec(x, cfg, window)
        ref = spec_kernel.spectrogram_fused_ref(x, cfg, fast=False)
        assert row_cosines(lib, ref).min().item() > 0.9999
        ms = cuda_ms(lambda: spec_kernel.spectrogram_fused(x, cfg, fast=fast))
        plain_ms = cuda_ms(lambda: spec_kernel.spectrogram_fused_ref(x, cfg, fast=fast), iters=5)
        library_ms = cuda_ms(lambda: library_spec(x, cfg, window))
        kernel_graph_ms = graph_ms(lambda: spec_kernel.spectrogram_fused(x, cfg, fast=fast))
        library_graph_ms = graph_ms(lambda: library_spec(x, cfg, window))
        wrapper_ms = host_ms(lambda: spec_kernel.spectrogram_fused(x, cfg, fast=fast))
        b8_ms = cuda_ms(lambda: spec_kernel.spectrogram_fused(x8, cfg, fast=fast))
        b8_graph_ms = graph_ms(lambda: spec_kernel.spectrogram_fused(x8, cfg, fast=fast))
        bound_ms, bound_by, count = spec_bound_ms(BATCH, 48000, cfg, fast)
        mode = "bf16" if fast else "f32"
        log(f"spec_frontend {mode} B={BATCH} orig (257x197): kernel {ms:.4f} ms per call back to back "
            f"(CUDA events, the wrapper's host time included); {kernel_graph_ms:.4f} ms in CUDA-graph "
            f"replay; wrapper host time {wrapper_ms:.4f} ms a call")
        log(f"spec_frontend {mode} B={AVC_BATCH} orig (257x197): kernel {b8_ms:.4f} ms (CUDA events); "
            f"{b8_graph_ms:.4f} ms in graph replay")
        log(f"spec_frontend {mode} B={BATCH} orig (257x197): plain {plain_ms:.4f} ms")
        log(f"spec_frontend {mode} B={BATCH} orig (257x197): library (torch.stft+abs) {library_ms:.4f} ms "
            f"(CUDA events); {library_graph_ms:.4f} ms in graph replay")
        log(f"spec_frontend {mode} B={BATCH} orig (257x197): bound {bound_ms:.4f} ms ({bound_by}; count: {count})")
        results[fast].update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                             bound_ms=bound_ms, bound_by=bound_by, graph_ms=kernel_graph_ms,
                             library_graph_ms=library_graph_ms, host_ms=wrapper_ms,
                             b8_ms=b8_ms, b8_graph_ms=b8_graph_ms)
    return results


def graph_ms(fn, iters: int = 20) -> float:
    """Device time per call of fn: `iters` calls captured in one CUDA graph
    and replayed between CUDA events, so that host launch gaps (a call
    made of many short launches) do not count."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture, as torch.cuda.graph asks
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def block1_bound_ms(flops: float, bytes_: float) -> tuple[float, str]:
    """Least time for a block-1 kernel's work: its operations at the bf16
    tensor-core peak or its bytes (each input read once, each output
    written once) at the HBM rate, whichever is larger."""
    ops_s, bytes_s = flops / PEAK_BF16_TC, bytes_ / PEAK_HBM
    return max(ops_s, bytes_s) * 1e3, ("operations" if ops_s > bytes_s else "bytes")


def library_gemm(a, w, s, b, reps):
    """cuBLAS: `reps` torch.matmul calls summed in f32, then ·s + b and ReLU
    → bf16: the GEMM probe's yardstick, timed only here."""
    acc = torch.zeros(a.shape[0], w.shape[1], device=a.device)
    for _ in range(reps):
        acc.add_(torch.matmul(a, w))
    return torch.relu_(acc.mul_(s).add_(b)).to(torch.bfloat16)


def block1_gate(what: str, got: torch.Tensor, want: torch.Tensor, rel_gate: float = 1e-2,
                cos_gate: float = 0.99999) -> float:
    """max |Δ| / max |ref| ≤ rel_gate and flattened cosine ≥ cos_gate (a
    kernel: 1e-2 and 0.99999; a yardstick, which rounds to bf16 before the
    epilogue, is only checked loosely); returns max |Δ|."""
    g, w = got.double().flatten(), want.double().flatten()
    max_abs = (g - w).abs().max().item()
    rel = max_abs / w.abs().max().item()
    cos = (g @ w / (g.norm() * w.norm())).item()
    log(f"{what}: max |d| {max_abs:.6g}, max |d|/max|ref| {rel:.3e} (<= {rel_gate}), "
        f"cosine {cos:.9f} (>= {cos_gate})")
    if not (rel <= rel_gate and cos >= cos_gate):
        raise SystemExit(f"{what}: disagrees")
    return max_abs


def cudnn_conv_relu_folded(x, w_folded, shift_bf16):
    """The conv's one-call yardstick: torch.cudnn_convolution_relu on
    channels-last bf16 x, W·scale folded into the weights (rounded to bf16)
    and shift as the bias. Timed only here; the port never calls it."""
    return torch.cudnn_convolution_relu(x.permute(0, 3, 1, 2), w_folded, shift_bf16,
                                        [1, 1], [1, 1], [1, 1], 1)


def check_block1_sass():
    """The block-1 kernels' design as their SASS shows it: every kernel
    function issues wgmma (HGMMA) fed by TMA (UTMALDG) or bulk copies
    (UBLKCP), and none mma.sync (HMMA)."""
    from l3embedding_torch.tools import block1_spike

    sass = block1_spike.library_sass()
    log(f"block1_conv SASS (cuobjdump -sass): {json.dumps(sass)}")
    names = " ".join(sass)
    ok = "block1_gemm" in names and "block1_conv" in names and all(
        ops["HGMMA"] > 0 and ops["UTMALDG"] + ops["UBLKCP"] > 0 and ops["HMMA"] == 0
        for ops in sass.values())
    if not ok:
        raise SystemExit("the block-1 kernels are not wgmma kernels fed by TMA")


def phase_block1(dev):
    """The block-1 probe kernels against their plain versions: the GEMM
    probe at N = 64 and 128 (reps 64), the fused conv+BN+ReLU at the vision
    conv1_2 shape (128, 224, 224, 64) and the linear types' audio conv1_2
    shape (128, 257, 197, 64); times beside cuBLAS / cuDNN (conv alone,
    conv + eager epilogue, and the one-call cudnn_convolution_relu) and the
    bound, with the share of bound at every shape. Then the main path: the
    probe tool's `all` at batch 128."""
    from l3embedding_torch.ops import block1_kernel as bk
    from l3embedding_torch.tools import block1_spike

    check_block1_sass()
    results = {}
    reps = 64
    for n_out in (64, 128):
        a, w, s, b = block1_spike.gemm_operands(n_out, torch.device(dev))
        what = f"block1_gemm N={n_out} reps={reps} (3584x576)"
        max_abs = block1_gate(what, bk.gemm_probe(a, w, s, b, reps), bk.gemm_probe_ref(a, w, s, b, reps))
        block1_gate(f"{what} cuBLAS yardstick", library_gemm(a, w, s, b, reps),
                    bk.gemm_probe_ref(a, w, s, b, reps), rel_gate=0.05, cos_gate=0.9999)
        ms = graph_ms(lambda: bk.gemm_probe(a, w, s, b, reps))
        events_ms = cuda_ms(lambda: bk.gemm_probe(a, w, s, b, reps))
        plain_ms = cuda_ms(lambda: bk.gemm_probe_ref(a, w, s, b, reps), iters=3, warmup=1)
        library_ms = graph_ms(lambda: library_gemm(a, w, s, b, reps))
        m, k = a.shape
        bound_ms, bound_by = block1_bound_ms(2.0 * m * k * n_out * reps, (m * k + k * n_out + m * n_out) * 2 + 2 * n_out * 4)
        log(f"{what}: kernel {ms:.4f} ms ({events_ms:.4f} by CUDA events), plain {plain_ms:.4f} ms, "
            f"library (cuBLAS matmul x{reps} + epilogue) {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}), {100 * bound_ms / ms:.1f} % of bound; device times from CUDA-graph "
            f"replay except plain and events")
        if n_out == 64:
            results["block1_gemm"] = {True: dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                                                 bound_ms=bound_ms, bound_by=bound_by, events_ms=events_ms)}

    gen = torch.Generator(device=dev).manual_seed(0)
    conv = {}
    for shape_name, (batch, h, wd) in (("vision", (128, 224, 224)), ("audio", (128, 257, 197))):
        x = (torch.randn(batch, h, wd, 64, device=dev, generator=gen) * 0.1).to(torch.bfloat16)
        wt = (torch.randn(576, 64, device=dev, generator=gen) * 0.05).to(torch.bfloat16)
        scale = torch.rand(64, device=dev, generator=gen) + 0.5
        shift = torch.randn(64, device=dev, generator=gen) * 0.1
        w_cl = wt.reshape(3, 3, 64, 64).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        w_folded = (w_cl.float() * scale[:, None, None, None]).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        shift_bf16 = shift.to(torch.bfloat16)
        what = f"block1_conv {shape_name} conv1_2 ({batch}, {h}, {wd}, 64)"
        want = bk.conv3x3_bn_relu_ref(x, wt, scale, shift)
        max_abs = block1_gate(what, bk.conv3x3_bn_relu(x, wt, scale, shift), want)
        with torch.backends.cudnn.flags(enabled=True, benchmark=True, allow_tf32=False):
            block1_gate(f"{what} cuDNN yardstick", block1_spike.cudnn_conv_bn_relu(x, w_cl, scale, shift),
                        want, rel_gate=0.05, cos_gate=0.9999)
            try:
                one_call = cudnn_conv_relu_folded(x, w_folded, shift_bf16)
            except RuntimeError as e:  # recorded, and the conv alone stays the yardstick
                log(f"{what}: torch.cudnn_convolution_relu refused: {e!r}"[:400])
                one_call = None
            refused = one_call is None
            if not refused:
                block1_gate(f"{what} cudnn_convolution_relu yardstick", one_call.permute(0, 2, 3, 1), want,
                            rel_gate=0.05, cos_gate=0.9999)
            del want, one_call
            eager_ms = cuda_ms(lambda: block1_spike.cudnn_conv_bn_relu(x, w_cl, scale, shift))
            conv_ms = cuda_ms(lambda: torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w_cl, padding=1))
            one_call_ms = None if refused else cuda_ms(lambda: cudnn_conv_relu_folded(x, w_folded, shift_bf16))
        ms = cuda_ms(lambda: bk.conv3x3_bn_relu(x, wt, scale, shift))
        plain_ms = cuda_ms(lambda: bk.conv3x3_bn_relu_ref(x, wt, scale, shift), iters=3, warmup=1)
        n_px = batch * h * wd
        bound_ms, bound_by = block1_bound_ms(2.0 * n_px * 576 * 64, 2 * n_px * 64 * 2 + 576 * 64 * 2 + 2 * 64 * 4)
        one_call_txt = f"{one_call_ms:.4f} ms" if one_call_ms is not None else "refused"
        log(f"{what}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library: cudnn_convolution_relu "
            f"(one call, W·scale folded) {one_call_txt}, cuDNN bf16 channels-last conv alone "
            f"{conv_ms:.4f} ms, conv + eager epilogue {eager_ms:.4f} ms; bound {bound_ms:.4f} ms "
            f"({bound_by}), {100 * bound_ms / ms:.1f} % of bound")
        conv[shape_name] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                                library_ms=one_call_ms if one_call_ms is not None else conv_ms,
                                library_conv_ms=conv_ms, library_eager_ms=eager_ms, bound_ms=bound_ms,
                                bound_by=bound_by)
        del x
        torch.cuda.empty_cache()
    audio = conv["audio"]
    results["block1_conv"] = {True: dict(conv["vision"], audio_ms=audio["ms"], audio_bound_ms=audio["bound_ms"],
                                         audio_library_ms=audio["library_ms"])}

    variants, counts = main_path(lambda: block1_spike.main(["all", "--batch", "128", "--steps", "5"]))
    log(f"block1_spike all --batch 128: launches {dict(counts)}")
    fused = variants[-1]
    if counts["block1_gemm_bf16"] < 1 or counts["block1_conv_bf16"] < 1 or not fused["rel_err"] <= 1e-2:
        raise SystemExit("the block-1 probe tool did not run its kernels or its check failed")
    torch.cuda.empty_cache()
    return results


PEAK_INT8_TC = 1979e12


def check_int8_sass():
    """The int8 conv's design as its SASS shows it: each wgmma kernel
    function (one per epilogue: requant, requant + pool, dequant) issues
    integer wgmma (IGMMA) fed by TMA (UTMALDG) and no mma.sync (IMMA)."""
    from l3embedding_torch.tools import int8_ab

    sass = int8_ab.library_sass()
    log(f"int8_conv SASS (cuobjdump -sass): {json.dumps(sass)}")
    wgmma = {k: v for k, v in sass.items() if k.startswith("int8_conv3x3_wgmma_kernel")}
    if len(wgmma) != 3 or not all(v["IGMMA"] > 0 and v["UTMALDG"] > 0 and v["IMMA"] == 0 for v in wgmma.values()):
        raise SystemExit("the int8 conv's wgmma kernels are not integer wgmma fed by TMA")


def int8_gate(what: str, got: torch.Tensor, want: torch.Tensor) -> tuple[float, bool]:
    """int8 outputs equal but for at most 1 LSB on at most 1e-4 of the
    elements; f32 within 1e-6 of the largest |value|. → (max |d|, ok)."""
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    if got.dtype == torch.int8:
        off = (diff > 0).float().mean().item()
        ok = err <= 1 and off <= 1e-4
        detail = f"max |d| {err:g} LSB on {off:.2e} of the elements (<= 1 LSB on <= 1e-4)"
    else:
        rel = err / want.abs().max().item()
        ok = rel <= 1e-6
        detail = f"max |d| {err:.3g}, {rel:.2e} of max |ref| (<= 1e-6)"
    log(f"{what}: {detail}")
    return err, ok and got.dtype == want.dtype and got.shape == want.shape


def phase_int8_kernel(dev) -> dict:
    """The int8 conv kernel against its plain version at each conv shape of
    the cnn_L3_melspec2 int8 tower at 64 windows (tools/int8_ab.SHAPES), and
    at the three pooled calls of blocks 1, 3 and 5 (the 2×2 pool in the
    kernel's epilogue; the plain conv then pool2_int8): int8 outputs equal
    but for at most 1 LSB on at most 1e-4 of the elements, the f32 epilogue
    within 1e-6 of the largest |value|. Kernel ms (CUDA events, 20 calls),
    plain ms, the library (im2col + torch._int_mm + torch epilogue, + the
    pool) and the bound (a pooled call writes a quarter of the bytes) at
    each, then their sums over the tower as it runs (the pooled call where
    it pools). The SASS of the wgmma kernels is checked first."""
    from l3embedding_torch.ops import int8_conv_kernel as ick
    from l3embedding_torch.tools import int8_ab

    check_int8_sass()
    gen = torch.Generator(device=dev).manual_seed(9)
    shapes, max_err = [], 0.0
    for h, w, cin, cout, requant, pooled in int8_ab.SHAPES:
        args = int8_ab.operands(h, w, cin, cout, requant, dev, gen)
        for pool in (False, True) if pooled else (False,):
            what = (f"int8_conv ({BATCH}, {h}, {w}, {cin}) -> {cout} {'requant' if requant else 'dequant'}"
                    f"{' + 2x2 pool' if pool else ''}")
            got = ick.conv3x3_s8(*args, pool=pool)
            want = ick.conv3x3_s8_ref(*args, pool=pool)
            torch.cuda.synchronize()
            err, ok = int8_gate(what, got, want)
            lib_err = (int8_ab.library_int8_conv(*args, pool=pool).float() - want.float()).abs().max().item()
            log(f"{what}: library max |d| {lib_err:g}")
            if not ok:
                raise SystemExit(f"{what}: the kernel disagrees with its plain version")
            max_err = max(max_err, err)
            del got, want
            ms = cuda_ms(lambda: ick.conv3x3_s8(*args, pool=pool))
            plain_ms = cuda_ms(lambda: ick.conv3x3_s8_ref(*args, pool=pool), iters=3, warmup=1)
            library_ms = cuda_ms(lambda: int8_ab.library_int8_conv(*args, pool=pool), iters=5, warmup=1)
            ops_s, bytes_s = int8_ab.int8_conv_bound(BATCH, h, w, cin, cout, requant, pool)
            bound_ms = max(ops_s, bytes_s) * 1e3
            log(f"{what}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library (im2col + _int_mm + "
                f"epilogue{' + pool' if pool else ''}) {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({'operations' if ops_s > bytes_s else 'bytes'}), {100 * bound_ms / ms:.1f} % of bound, "
                f"{2.0 * BATCH * h * w * 9 * cin * cout / ms / 1e9:.1f} TOP/s")
            shapes.append(dict(shape=[BATCH, h, w, cin, cout], pool=pool, on_path=pool == pooled, ms=ms,
                               plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                               ops_ms=ops_s * 1e3, bytes_ms=bytes_s * 1e3))
        del args
        torch.cuda.empty_cache()
    tower = [s for s in shapes if s["on_path"]]
    total = {k: sum(s[k] for s in tower) for k in ("ms", "plain_ms", "library_ms", "bound_ms", "ops_ms", "bytes_ms")}
    log(f"int8_conv tower sum over its {len(tower)} calls at B={BATCH} (pooled after blocks 1, 3, 5): kernel "
        f"{total['ms']:.4f} ms, plain {total['plain_ms']:.4f} ms, library {total['library_ms']:.4f} ms, bound "
        f"{total['bound_ms']:.4f} ms ({100 * total['bound_ms'] / total['ms']:.1f} % of bound); "
        + subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return {True: dict(max_abs_err=max_err, ms=total["ms"], plain_ms=total["plain_ms"],
                       library_ms=total["library_ms"], bound_ms=total["bound_ms"],
                       bound_by="operations" if total["ops_ms"] > total["bytes_ms"] else "bytes",
                       shapes=shapes)}


def main_path(fn):
    """Run one main-path call with every kernel count at 0 just before it;
    add the counts read just after to MAIN_PATH_LAUNCHES and return
    (result, counts)."""
    from l3embedding_torch.ops import block1_kernel, int8_conv_kernel, mel_kernel, spec_kernel

    mel_kernel.LAUNCHES.clear()
    spec_kernel.LAUNCHES.clear()
    block1_kernel.LAUNCHES.clear()
    int8_conv_kernel.LAUNCHES.clear()
    out = fn()
    torch.cuda.synchronize()
    counts = Counter({f"mel_frontend_{k}": v for k, v in mel_kernel.LAUNCHES.items()})
    counts.update({f"spec_frontend_{k}": v for k, v in spec_kernel.LAUNCHES.items()})
    counts.update({f"{k}_bf16": v for k, v in block1_kernel.LAUNCHES.items()})
    counts.update({f"int8_conv_{k}": v for k, v in int8_conv_kernel.LAUNCHES.items()})
    MAIN_PATH_LAUNCHES.update(counts)
    return out, counts


def front_end_kernel(model_type: str, fast: bool) -> str:
    """The kernel a model type's audio front end must launch."""
    name = "mel_frontend" if "melspec" in model_type else "spec_frontend"
    return f"{name}_{'bf16' if fast and model_type != 'tiny_L3' else 'f32'}"


def phase_slice(dev):
    """Extraction through EmbeddingExtractor for all five model types:
    cnn_L3_melspec2 and cnn_L3_orig in both poolings, the others 'short';
    f32 and bf16; rows against a CPU copy of the same weights, windows/s.
    Then get_audio_embedding for mel256 and linear."""
    from l3embedding_torch import api
    from l3embedding_torch.embed.extract import EmbeddingExtractor

    rng = np.random.RandomState(1)
    windows = (rng.randn(BATCH, 48000) * 0.2).astype(np.float32)
    windows[3, 10000:30000] = 0.0  # a silent stretch inside one window
    for model_type in MODEL_TYPES:
        full = model_type in ("cnn_L3_melspec2", "cnn_L3_orig")
        poolings = (("short", 512), ("original", 6144)) if full else (("short", None),)
        for fast in (False, True):
            gate = 0.999 if fast and model_type != "tiny_L3" else 0.9999
            for pooling, dim in poolings:
                ext = EmbeddingExtractor(None, model_type, pooling, fast=fast, device=dev)
                emb, counts = main_path(lambda: ext.embed_windows(windows))
                kernel = front_end_kernel(model_type, fast)
                assert emb.shape[0] == BATCH and (dim is None or emb.shape[1] == dim), emb.shape
                assert np.isfinite(emb).all()
                if counts[kernel] < 1:
                    raise SystemExit(f"{model_type} extraction did not go through {kernel}")
                cpu_model = copy.deepcopy(ext.model).to("cpu")
                cpu_rows = cpu_model(torch.from_numpy(windows[:4])[:, None, :])
                cos = row_cosines(torch.from_numpy(emb[:4]), cpu_rows).min().item()
                log(f"extractor {model_type} fast={fast} {pooling}: {emb.shape}, launches "
                    f"{dict(counts)}, min cosine vs CPU copy {cos:.7f} (>= {gate})")
                if cos < gate:
                    raise SystemExit(f"{model_type}: GPU rows disagree with the CPU copy")
                t0 = time.perf_counter()
                reps = 3
                for _ in range(reps):
                    ext.embed_windows(windows)
                dt = (time.perf_counter() - t0) / reps
                log(f"extractor {model_type} fast={fast} {pooling}: {BATCH / dt:.1f} windows/s")

    clip = (np.sin(2 * np.pi * 440 * np.arange(int(3.3 * 44100)) / 44100) * 0.3
            + rng.randn(int(3.3 * 44100)) * 0.05).astype(np.float32)
    ext = EmbeddingExtractor(None, "cnn_L3_melspec2", "short", device=dev)
    (emb_c, ts), _ = main_path(lambda: api.get_audio_embedding(clip, 44100, model=ext))
    # 158400 samples at 48 kHz, half a window of front padding.
    rows = 1 + int(np.ceil((158400 + 24000 - 48000) / 4800))
    assert emb_c.shape == (rows, 512) and ts.shape == (rows,), (emb_c.shape, ts.shape)
    assert np.isfinite(emb_c).all()
    log(f"get_audio_embedding mel256 3.3 s @ 44.1 kHz: {emb_c.shape}, ts {ts[:3]}..{ts[-1]:.1f}")

    short = clip[: int(1.2 * 44100)]
    (emb_l, _), counts = main_path(
        lambda: api.get_audio_embedding(short, 44100, input_repr="linear", device=dev))
    emb_cpu, _ = api.get_audio_embedding(short, 44100, input_repr="linear", device="cpu")
    cos = row_cosines(torch.from_numpy(emb_l), torch.from_numpy(emb_cpu)).min().item()
    log(f"get_audio_embedding linear 1.2 s @ 44.1 kHz: {emb_l.shape}, launches {dict(counts)}, "
        f"min cosine vs CPU {cos:.7f} (>= 0.9999)")
    if counts["spec_frontend_f32"] < 1 or cos < 0.9999 or not np.isfinite(emb_l).all():
        raise SystemExit("get_audio_embedding(input_repr='linear') failed on the card")


def phase_avc(dev):
    """The AVC forward (vision + audio towers + head) at batch 8, as
    __graft_entry__.entry(), for all five model types, f32 and bf16 (tiny:
    f32 only, as in the JAX package): logits and predict_proba against a CPU
    copy of the same weights, and the forward's time."""
    from l3embedding_torch.models.registry import build_model

    rng = np.random.RandomState(0)
    video = torch.from_numpy(rng.rand(AVC_BATCH, 224, 224, 3).astype(np.float32) * 2 - 1)
    audio = torch.from_numpy((rng.rand(AVC_BATCH, 1, 48000).astype(np.float32) * 2 - 1) * 0.5)
    v_dev, a_dev = video.to(dev), audio.to(dev)
    for model_type in MODEL_TYPES:
        for fast in ((False,) if model_type == "tiny_L3" else (False, True)):
            dtype = torch.bfloat16 if fast else torch.float32
            gate = 0.999 if fast else 0.9999
            model = build_model(model_type).module(dtype)
            model.reset_parameters(torch.Generator().manual_seed(0))
            model = model.eval().to(dev)
            with torch.no_grad():
                logits, counts = main_path(lambda: model(v_dev, a_dev))
                kernel = front_end_kernel(model_type, fast)
                if counts[kernel] < 1:
                    raise SystemExit(f"{model_type} AVC forward did not go through {kernel}")
                proba = model.predict_proba(v_dev, a_dev)
                assert logits.shape == (AVC_BATCH, 2) and logits.dtype == torch.float32
                assert torch.isfinite(logits).all()
                assert torch.allclose(proba.sum(-1), torch.ones(AVC_BATCH, device=dev))
                rows = 2 if fast else 4
                cpu_logits = copy.deepcopy(model).to("cpu")(video[:rows], audio[:rows])
                got = logits[:rows].cpu()
                cos = row_cosines(got.reshape(1, -1), cpu_logits.reshape(1, -1)).item()
                rel = ((got - cpu_logits).abs().max() / cpu_logits.abs().max()).item()
                ms = cuda_ms(lambda: model(v_dev, a_dev), iters=5, warmup=1)
            log(f"avc {model_type} fast={fast}: logits {tuple(logits.shape)}, launches {dict(counts)}, "
                f"cosine vs CPU copy {cos:.7f} (>= {gate}), max |d|/max {rel:.2e}, "
                f"forward {ms:.3f} ms at batch {AVC_BATCH}")
            if cos < gate:
                raise SystemExit(f"{model_type}: AVC logits disagree with the CPU copy")


def phase_image(dev):
    """get_image_embedding on three 240×320 uint8 frames (min-side resize,
    center crop) with cnn_L3_orig's vision tower, against a CPU copy."""
    from l3embedding_torch import api

    frames = np.random.RandomState(5).randint(0, 256, (3, 240, 320, 3), dtype=np.uint8)
    model = api.ImageEmbeddingModel(model_type="cnn_L3_orig", device=dev)
    emb, ts = api.get_image_embedding(frames, 25.0, model=model)
    assert emb.shape == (3, 8192) and np.isfinite(emb).all(), emb.shape
    x = api.preprocess_frames(frames)
    x = torch.from_numpy(2.0 * (x.astype(np.float32) / 255.0) - 1.0)
    cpu_rows = copy.deepcopy(model.model).to("cpu")(x)
    cos = row_cosines(torch.from_numpy(emb), cpu_rows).min().item()
    log(f"get_image_embedding 3x240x320 uint8 (cnn_L3_orig): {emb.shape}, ts {ts}, "
        f"min cosine vs CPU copy {cos:.7f} (>= 0.9999)")
    if cos < 0.9999:
        raise SystemExit("image embeddings disagree with the CPU copy")


GATES = {False: 0.99999, True: 0.999}  # rows of two paths / a CPU copy, by fast


def fixture_wav(path: str, seconds: float, sr: int, seed: int) -> None:
    """A stereo 16-bit WAV of a tone over noise whose level changes every
    0.37 s (loud and quiet windows, so that the batch-global dB quirk
    matters), written with the stdlib."""
    from l3embedding_torch.data.audio_io import write_wav

    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * sr)) / sr
    level = rng.uniform(0.02, 0.6, int(np.ceil(seconds / 0.37)))[(t / 0.37).astype(int)]
    mono = level * (0.5 * np.sin(2 * np.pi * 440 * t) + 0.5 * rng.randn(t.size))
    stereo = np.stack([mono, 0.7 * mono + 0.05 * rng.randn(t.size)], axis=1)
    write_wav(path, (np.clip(stereo, -1, 1) * 32767).astype(np.int16), sr)


def check_rows(what: str, got: np.ndarray, want: np.ndarray, gate: float) -> float:
    if got.shape != want.shape or not np.isfinite(got).all():
        raise SystemExit(f"{what}: rows {got.shape} against {want.shape}, or not finite")
    cos = row_cosines(torch.from_numpy(got), torch.from_numpy(want)).min().item()
    log(f"{what}: {got.shape}, min cosine {cos:.7f} (>= {gate})")
    if cos < gate:
        raise SystemExit(f"{what}: rows disagree")
    return cos


def loudest_window(windows: np.ndarray, dev) -> int:
    """The window holding the batch's largest mel amplitude: the row that
    sets the batch-global dB reference (found with the f32 kernel in
    amplitude mode; a call outside the main paths)."""
    from l3embedding_torch.ops.frontend import MelConfig
    from l3embedding_torch.ops.mel_kernel import melspectrogram_fused

    feats = melspectrogram_fused(torch.from_numpy(windows).to(dev), MelConfig(n_mels=256, decibel=False))
    return int(feats.flatten(1).amax(1).argmax().item())


def phase_files(dev):
    """Extraction from files on cnn_L3_melspec2 at full width, f32 and bf16:
    embed_file on a 10.3 s stereo 44.1 kHz WAV with device framing and with
    host framing, db_batch_global off and on: the two paths' rows against
    each other and against a CPU copy of the weights (rows 0-2 and the
    loudest window, which together keep the batch-global dB reference),
    the bytes each path uploads and its host-clock time per file (5 calls
    after a warm-up); a 0.7 s clip on the host path; then
    process_audio_file, process_image_file (.npy), process_video_file (.npz)
    and api.main, whose npz files must have the JAX package's names, keys
    and shapes."""
    import tempfile

    from l3embedding_torch import api
    from l3embedding_torch.data.audio_io import load_audio
    from l3embedding_torch.embed.extract import EmbeddingExtractor, frame_uniform

    tmp = tempfile.TemporaryDirectory()
    wav = os.path.join(tmp.name, "clip.wav")
    fixture_wav(wav, 10.3, 44100, seed=11)
    audio = load_audio(wav, 48000)
    windows = frame_uniform(audio)
    n = windows.shape[0]
    loud = loudest_window(windows, dev)
    rows = sorted({0, 1, 2, loud})
    log(f"files: 10.3 s stereo 44.1 kHz WAV -> {audio.size} samples at 48 kHz, {n} windows "
        f"(bucket {api._bucket(n)}), loudest window {loud}")
    short = audio[: int(0.7 * 48000)]
    for fast in (False, True):
        mode, kernel = ("bf16" if fast else "f32"), front_end_kernel("cnn_L3_melspec2", fast)
        for dbg in (False, True):
            what = f"files melspec2 {mode} db_batch_global={dbg}"
            ext = EmbeddingExtractor(None, "cnn_L3_melspec2", "short", fast=fast, db_batch_global=dbg, device=dev)
            got, uploaded = {}, {}
            for framing in (True, False):
                ext.device_framing = framing
                b0 = ext.bytes_uploaded
                got[framing], counts = main_path(lambda: ext.embed_file(wav))
                uploaded[framing] = ext.bytes_uploaded - b0
                if counts[kernel] < 1:
                    raise SystemExit(f"{what}: device_framing={framing} did not launch {kernel}")
            check_rows(f"{what}: device framing against host framing", got[True], got[False], GATES[fast])
            cpu_rows = copy.deepcopy(ext.model).to("cpu")(torch.from_numpy(windows[rows])[:, None, :])
            check_rows(f"{what}: device framing rows {rows} against a CPU copy", got[True][rows],
                       cpu_rows.numpy(), 0.999 if fast else 0.9999)
            log(f"{what}: bytes uploaded per file: device framing {uploaded[True]}, host framing "
                f"{uploaded[False]} ({uploaded[False] / uploaded[True]:.2f}x)")
            if not dbg:
                per_file = {}
                for framing in (True, False, False, True):  # in turns
                    ext.device_framing = framing
                    ext.embed_file(wav)
                    t0 = time.perf_counter()
                    for _ in range(5):
                        ext.embed_file(wav)
                    per_file.setdefault(framing, []).append((time.perf_counter() - t0) * 1e3 / 5)
                log(f"{what}: host-clock time per file (embed_file, 5 calls after a warm-up, in turns "
                    f"device, host, host, device): device framing {per_file[True][0]:.3f} / "
                    f"{per_file[True][1]:.3f} ms, host framing {per_file[False][0]:.3f} / "
                    f"{per_file[False][1]:.3f} ms")
            b0 = ext.bytes_uploaded
            short_rows, counts = main_path(lambda: ext.embed_audio(short, device_framing=True))
            if ext.bytes_uploaded - b0 != 48000 * 4 or counts[kernel] < 1:
                raise SystemExit(f"{what}: the 0.7 s clip did not take the host path ({ext.bytes_uploaded - b0} B)")
            check_rows(f"{what}: 0.7 s clip (host path) against embed_windows", short_rows,
                       ext.embed_windows(frame_uniform(short)), GATES[fast])
            del ext
            torch.cuda.empty_cache()

    out_dir = os.path.join(tmp.name, "out")
    os.makedirs(out_dir)
    rng = np.random.RandomState(12)
    image = os.path.join(tmp.name, "image.npy")
    np.save(image, rng.randint(0, 256, (240, 320, 3), dtype=np.uint8))
    video = os.path.join(tmp.name, "video.npz")
    np.savez(video, video=rng.randint(0, 256, (6, 256, 300, 3), dtype=np.uint8),
             audio=(rng.uniform(-0.4, 0.4, 72000) * 32767).astype(np.int16), sr=48000, fps=3.0)
    ext = api.load_audio_embedding_model(device=dev)
    img_model = api.ImageEmbeddingModel(device=dev)
    out, counts = main_path(lambda: api.process_audio_file(wav, out_dir, "a", model=ext))
    n_centered = 1 + int(np.ceil((audio.size + 24000 - 48000) / 4800))
    expect = {out: {"embedding": (n_centered, 512), "timestamps": (n_centered,)}}
    outs, _ = main_path(lambda: api.process_image_file([image], out_dir, model=img_model))
    expect[outs[0]] = {"embedding": (8192,)}
    entry, _ = main_path(lambda: api.process_video_file(video, out_dir, audio_model=ext, image_model=img_model))
    expect[entry["image"]] = {"embedding": (2, 8192), "timestamps": (2,)}
    n_video = 1 + int(np.ceil((72000 + 24000 - 48000) / 4800))
    expect[entry["audio"]] = {"embedding": (n_video, 512), "timestamps": (n_video,)}
    rc, cli_counts = main_path(lambda: api.main([wav, "--output-dir", out_dir, "--suffix", "cli", "--device", dev]))
    expect[os.path.join(out_dir, "clip_cli.npz")] = {"embedding": (n_centered, 512), "timestamps": (n_centered,)}
    names = {os.path.basename(p) for p in expect}
    if rc != 0 or names != {"clip_a.npz", "image.npz", "video_image.npz", "video_audio.npz", "clip_cli.npz"}:
        raise SystemExit(f"api files: rc {rc}, names {sorted(names)}")
    for path, shapes in expect.items():
        with np.load(path) as data:
            got = {k: data[k].shape for k in data.files}
            finite = all(np.isfinite(data[k]).all() for k in data.files)
        log(f"api {os.path.basename(path)}: {got}")
        if got != shapes or not finite:
            raise SystemExit(f"{path}: keys and shapes {got}, expected {shapes}")
    with np.load(entry["image"]) as data:
        if not np.allclose(data["timestamps"], [0.0, 1.0]):
            raise SystemExit(f"video image timestamps {data['timestamps']}")
    if counts["mel_frontend_f32"] < 1 or cli_counts["mel_frontend_f32"] < 1:
        raise SystemExit("process_audio_file / api.main did not launch mel_frontend_f32")
    tmp.cleanup()


SERVE_SECONDS = 4.0  # each closed-loop run lasts at least this long,
SERVE_MIN_REQUESTS = 1000  # and completes at least this many requests (p99 with 10 beyond)


def phase_serve(dev):
    """EmbeddingService on cnn_L3_melspec2, f32 and bf16, under 1, 16 and 64
    closed-loop client threads sending one-window requests, at
    pipeline_depth 1 and 2, each for SERVE_SECONDS and at least
    SERVE_MIN_REQUESTS requests: submit→resolve p50/p95/p99 (each only with
    10 samples beyond it), clips/s, mean coalesced batch, the host time per
    batch spent coalescing, dispatching and collecting, and rows against
    embed_windows; embed_windows' own time at 1, 16 and 64 windows beside
    it. Then StreamingEmbedder (0.37 s chunks against embed_audio on the
    whole clip) and the HTTP server on 127.0.0.1:0
    (/healthz, /statz, /v1/embed, /v1/embed_windows, a stream session, drain
    and close)."""
    import json as json_
    import urllib.request

    from l3embedding_torch.embed.extract import EmbeddingExtractor, _bucket, frame_uniform
    from l3embedding_torch.embed.http_serve import make_server, serve_forever_in_thread
    from l3embedding_torch.embed.service import EmbeddingService
    from l3embedding_torch.embed.stream import StreamingEmbedder
    from l3embedding_torch.tools.serve_load import closed_loop

    rng = np.random.RandomState(21)
    payloads = (rng.randn(64, 48000) * 0.2 * rng.uniform(0.05, 1.0, (64, 1))).astype(np.float32)
    clip = (rng.randn(int(3.3 * 48000)) * 0.1).astype(np.float32)
    for fast in (False, True):
        mode, kernel = ("bf16" if fast else "f32"), front_end_kernel("cnn_L3_melspec2", fast)
        ext = EmbeddingExtractor(None, "cnn_L3_melspec2", "short", fast=fast, device=dev)
        want = ext.embed_windows(payloads)
        for batch in (1, 16, 64):  # one call, host clock, to the rows on the host
            ext.embed_windows(payloads[:batch])
            t0 = time.perf_counter()
            for _ in range(20):
                ext.embed_windows(payloads[:batch])
            ms = (time.perf_counter() - t0) * 1e3 / 20
            log(f"serve melspec2 {mode}: embed_windows of {batch} window(s) (bucket {_bucket(batch)}): "
                f"{ms:.3f} ms per call (host clock, 20 calls), {batch * 1e3 / ms:.1f} windows/s")
        # 1 client at both depths; 16 and 64 clients at depths 1, 2, 2, 1 in turns.
        for clients, depths in ((1, (1, 2)), (16, (1, 2, 2, 1)), (64, (1, 2, 2, 1))):
            for depth in depths:
                with EmbeddingService(ext, max_batch_size=128, max_latency_ms=5.0, pipeline_depth=depth) as svc:
                    closed_loop(svc, 4, payloads, seconds=0.0, min_requests=8)  # warm-up
                    stats, counts = main_path(lambda: closed_loop(
                        svc, clients, payloads, seconds=SERVE_SECONDS, min_requests=SERVE_MIN_REQUESTS))
                    if counts[kernel] < 1:
                        raise SystemExit(f"serve {mode}: the service did not launch {kernel}")
                    got = np.concatenate([r for r in stats["first"]])
                    ids = [c % 64 for c in range(clients)]
                    cos = row_cosines(torch.from_numpy(got), torch.from_numpy(want[ids])).min().item()
                    pct = ", ".join(f"p{p} {stats[f'p{p}_ms']:.3f} ms" if stats[f"p{p}_ms"] is not None
                                    else f"p{p} n/a" for p in (50, 95, 99))
                    log(f"serve melspec2 {mode} depth={depth} clients={clients}: {stats['requests']} requests "
                        f"in {stats['seconds']:.2f} s: {pct}, {stats['clips_per_s']:.1f} clips/s, mean "
                        f"coalesced batch {stats['mean_coalesced_batch']:.2f} over {stats['device_batches']} "
                        f"batches; per batch (host clock) coalescing {stats['coalesce_ms_per_batch']:.3f} ms, "
                        f"dispatch {stats['dispatch_ms_per_batch']:.3f} ms, collection "
                        f"{stats['collect_ms_per_batch']:.3f} ms; min cosine vs embed_windows {cos:.7f} "
                        f"(>= {GATES[fast]})")
                    if cos < GATES[fast]:
                        raise SystemExit(f"serve {mode}: service rows disagree with embed_windows")
                    if svc.stats_snapshot()["errors"]:
                        raise SystemExit(f"serve {mode}: the service counted errors")

        def stream():
            s = StreamingEmbedder(ext)
            step = int(0.37 * 48000)
            out = [s.feed(clip[i : i + step]) for i in range(0, clip.size, step)] + [s.flush()]
            return np.concatenate([r for r in out if r.size])

        streamed, counts = main_path(stream)
        if counts[kernel] < 1:
            raise SystemExit(f"stream {mode}: did not launch {kernel}")
        check_rows(f"stream melspec2 {mode}: 0.37 s chunks against embed_audio", streamed,
                   ext.embed_audio(clip), GATES[fast])

        def http():
            srv = make_server(ext, "127.0.0.1", 0, max_latency_ms=5.0)
            serve_forever_in_thread(srv)
            host, port = srv.server_address[:2]
            url = f"http://{host}:{port}"

            def post(path, data, headers=None):
                with urllib.request.urlopen(urllib.request.Request(url + path, data=data, headers=headers or {})) as r:
                    return r.read(), r.headers

            try:
                with urllib.request.urlopen(url + "/healthz") as r:
                    health = json_.load(r)
                body, _ = post("/v1/embed", json_.dumps({"audio": clip[:96000].tolist(), "hop": 0.5}).encode(),
                               {"Content-Type": "application/json"})
                emb = np.asarray(json_.loads(body)["embeddings"], np.float32)
                raw, headers = post("/v1/embed_windows", payloads[:3].tobytes(), {"X-Num-Windows": "3"})
                rows = np.frombuffer(raw, "<f4").reshape(3, int(headers["X-Embedding-Dim"]))
                sid = json_.loads(post("/v1/stream/open", json_.dumps({"hop": 0.1}).encode())[0])["stream_id"]
                chunks = []
                for i in range(0, 96000, 17760):
                    blob, h = post(f"/v1/stream/{sid}/feed", clip[i : min(i + 17760, 96000)].tobytes())
                    chunks.append(np.frombuffer(blob, "<f4").reshape(int(h["X-Num-Windows"]), health["dim"]))
                blob, h = post(f"/v1/stream/{sid}/flush", b"")
                chunks.append(np.frombuffer(blob, "<f4").reshape(int(h["X-Num-Windows"]), health["dim"]))
                with urllib.request.urlopen(url + "/statz") as r:
                    statz = json_.load(r)
                drained = srv.l3_service.drain(timeout=30)
            finally:
                srv.shutdown()
                srv.l3_service.close()
                srv.server_close()
            return health, emb, rows, np.concatenate(chunks), statz, drained

        (health, emb, rows, streamed, statz, drained), counts = main_path(http)
        log(f"http melspec2 {mode}: /healthz {health}; /statz requests {statz['requests']}, "
            f"p50 {statz['latency_ms_p50']} ms; drained {drained}; launches {dict(counts)}")
        if health["dim"] != want.shape[1] or statz["requests"] < 1 or not drained or counts[kernel] < 1:
            raise SystemExit(f"http {mode}: healthz/statz/drain failed or {kernel} not launched")
        check_rows(f"http melspec2 {mode}: /v1/embed against embed_windows", emb,
                   ext.embed_windows(frame_uniform(clip[:96000], hop_size=0.5)), GATES[fast])
        check_rows(f"http melspec2 {mode}: /v1/embed_windows against embed_windows", rows, want[:3], GATES[fast])
        check_rows(f"http melspec2 {mode}: stream session against embed_audio", streamed,
                   ext.embed_audio(clip[:96000]), GATES[fast])
        del ext
        torch.cuda.empty_cache()


def phase_profile(dev):
    """Where one 64-window extractor call spends device time, per model type
    and mode: the top kernels by self device time, and the device's idle
    share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    from l3embedding_torch.embed.extract import EmbeddingExtractor

    windows = (np.random.RandomState(2).randn(BATCH, 48000) * 0.2).astype(np.float32)
    for model_type in ("cnn_L3_melspec2", "cnn_L3_orig"):
        for fast in (False, True):
            ext = EmbeddingExtractor(None, model_type, "short", fast=fast, device=dev)
            ext.embed_windows(windows)
            reps = 3
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
                t0 = time.perf_counter()
                for _ in range(reps):
                    ext.embed_windows(windows)
                wall_ms = (time.perf_counter() - t0) * 1e3 / reps

            log_profile(f"profile {model_type} fast={fast}", prof, reps, wall_ms,
                        f"{BATCH * 1e3 / wall_ms:.1f} windows/s under the profiler", "call")


def log_profile(what: str, prof, reps: int, wall_ms: float, rate: str, unit: str) -> None:
    """Device busy time per `unit` and the idle share of the wall time, then
    the top 8 device events by time. Busy time is the union of the
    intervals of the device's own events (kernels, copies, sets): the
    host-side aten ops carry their kernels' time too, and the device-side
    ranges of record_function annotations span their kernels and the gaps
    between them, so both are left out. The shares are of the summed event
    time."""
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    events = [e for e in device if not getattr(e, "is_user_annotation", False)]
    busy_us, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in events):
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    by_name = defaultdict(float)
    for e in events:
        by_name[e.name] += e.time_range.elapsed_us()
    busy_ms = busy_us / 1e3 / reps
    sum_ms = sum(by_name.values()) / 1e3 / reps
    log(f"{what}: wall {wall_ms:.3f} ms/{unit} ({rate}), device busy {busy_ms:.3f} ms/{unit} "
        f"(union of {len(events)} device events, whose times sum to {sum_ms:.3f}; "
        f"{len(device) - len(events)} annotation ranges left out), idle share {1 - busy_ms / wall_ms:.3f}")
    for name, us in sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:8]:
        ms = us / 1e3 / reps
        log(f"  {ms:8.3f} ms  {100 * ms / sum_ms:5.1f}%  {name[:90]}")


TRAIN_MODEL = "cnn_L3_melspec2"
TRAIN_BATCH = 16  # the train() run: one epoch of 4 steps, 2 validation batches
CMP_BATCH = 4  # the card step against the CPU step
TIMING_BATCH = 64


def avc_batches(n: int, batch: int, seed: int) -> list[dict]:
    """n batches in the storage dtypes of the 02 corpus (uint8 video, int16
    audio, one-hot labels), made in bulk from a seed."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 2, (n, batch))
    video = rng.randint(0, 256, (n, batch, 224, 224, 3), dtype=np.uint8)
    audio = (rng.randn(n, batch, 1, 48000) * 3000).astype(np.int16)
    return [{"video": video[i], "audio": audio[i],
             "label": np.stack([labels[i], 1 - labels[i]], 1).astype(np.float32)} for i in range(n)]


def write_h5_corpus(path: str, batches: list[dict]) -> None:
    """One h5 batch file per batch, as 02_generate_samples.py writes them."""
    import h5py

    os.makedirs(path, exist_ok=True)
    for i, b in enumerate(batches):
        with h5py.File(os.path.join(path, f"blob_{i}.h5"), "w") as f:
            for k, v in b.items():
                f.create_dataset(k, data=v)


def one_train_step(dtype, device, batch: dict, tf32_probe: bool = False, accum_steps: int = 1,
                   save_to: str | None = None):
    """One step of a fresh seeded state → (metrics, grads, running stats,
    TF32 flags seen during the backward), tensors as f64 on the CPU; the new
    state written to `save_to` when given."""
    from l3embedding_torch.models.registry import build_model
    from l3embedding_torch.training import checkpoints
    from l3embedding_torch.training.state import create_train_state
    from l3embedding_torch.training.steps import make_train_step

    state = create_train_state(build_model(TRAIN_MODEL), torch.Generator().manual_seed(5), 1e-4,
                               dtype, device)
    seen = []
    if tf32_probe:
        w = state.model.audio_model.embedding_conv.weight
        w.register_hook(lambda g: seen.append(torch.backends.cudnn.allow_tf32))
    state, metrics = make_train_step(accum_steps)(state, {k: torch.from_numpy(v).to(device) for k, v in batch.items()})
    if save_to is not None:
        checkpoints.save_state(save_to, state)
    grads = {n: p.grad.double().cpu() for n, p in state.model.named_parameters()}
    stats = {n: b.double().cpu() for n, b in state.model.named_buffers() if "running" in n}
    return {k: float(v) for k, v in metrics.items()}, grads, stats, seen


def leaf_cosines(a: dict, b: dict, skip=()) -> dict:
    return {n: torch.nn.functional.cosine_similarity(a[n].flatten(), b[n].flatten(), dim=0).item()
            for n in a if n not in skip}


def step_agreement(what: str, card: tuple, cpu: tuple, noise: dict, f32: bool) -> tuple[bool, float, dict, float]:
    """One train step on the card against the same step on a CPU copy (each
    ``one_train_step``'s result): logs the agreement and returns (the f32
    gates passed, loss relative error, BN statistics cosines, batch
    statistics' max relative error). An f32 step must keep TF32 off in its
    backward, and the BN-fed conv biases' gradients must be ~0."""
    m, grads, stats, seen = card
    m_cpu, g_cpu, s_cpu, _ = cpu
    if f32:
        if seen != [False]:
            raise SystemExit(f"{what}: TF32 on during the backward: {seen}")
        for n, bn in noise.items():
            for g in (grads, g_cpu):
                if g[n].abs().max() > 1e-3 * g[bn].abs().max():
                    raise SystemExit(f"{what}: {n} gradient is not ~0: {g[n].abs().max()}")
    cos = leaf_cosines(grads, g_cpu, skip=noise)
    worst = min(cos, key=cos.get)
    err = max((grads[n] - g_cpu[n]).abs().max().item() for n in cos)
    bn_cos = leaf_cosines(stats, s_cpu)
    # The batch's own statistics, from new = 0.99·old + 0.01·batch (a fresh
    # state: running mean 0, running variance 1).
    batch_stat = lambda s, n: (s[n] - (0.99 if n.endswith("var") else 0.0)) / 0.01  # noqa: E731
    stat_err = max(((batch_stat(stats, n) - batch_stat(s_cpu, n)).abs().max()
                    / batch_stat(s_cpu, n).abs().max()).item() for n in stats)
    loss_rel = abs(m["loss"] - m_cpu["loss"]) / abs(m_cpu["loss"])
    log(f"{what}: loss {m['loss']:.6f} / {m_cpu['loss']:.6f} (rel {loss_rel:.2e}), acc {m['acc']:.3f} / "
        f"{m_cpu['acc']:.3f}, gradient leaves min cosine {cos[worst]:.7f} ({worst}), max |d| {err:.3e}; "
        f"BN statistics min cosine {min(bn_cos.values()):.7f}, batch statistics max relative "
        f"error {stat_err:.2e}; TF32 in backward {seen}")
    ok = (loss_rel <= 1e-4 and cos[worst] >= 0.9999 and stat_err <= 1e-3
          and min(bn_cos.values()) >= 0.9999 and m["acc"] == m_cpu["acc"])
    return ok, loss_rel, bn_cos, stat_err


def phase_train(dev):
    """The AVC training path on cnn_L3_melspec2 at full width, f32 and bf16:
    the port's epoch cycle (train steps, eval steps, the four checkpoint
    roles, the history files) at batch 16 for one epoch of 4 steps and 2
    validation batches, through train() on an h5 corpus where h5py is
    installed and through run_epochs on the same batches in memory where it
    is not; the best-valid-loss checkpoint loaded into EmbeddingExtractor;
    one step at batch 4 against the same step on a CPU copy (gradients and
    BN statistics); 10 steps on one batch, whose loss must fall; then the
    step time, pairs/s and peak memory at batch 64 and a profile of 3
    steps. TF32 is set to torch's defaults for the phase: the f32 step must
    keep it off itself, backward included. Returns the f32 state of the
    timed steps (full width, 15 steps) as ``checkpoints.state_tree``."""
    import importlib.util
    import itertools
    import pickle
    import statistics
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from l3embedding_torch.compat.from_jax import bn_fed_biases
    from l3embedding_torch.embed.extract import EmbeddingExtractor
    from l3embedding_torch.models.registry import build_model
    from l3embedding_torch.training import checkpoints, loop
    from l3embedding_torch.training.state import create_train_state
    from l3embedding_torch.training.steps import make_eval_step, make_train_step

    spec = build_model(TRAIN_MODEL)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    prev_tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    tmp = tempfile.TemporaryDirectory()
    try:
        train_b = avc_batches(4, TRAIN_BATCH, seed=21)
        valid_b = avc_batches(2, TRAIN_BATCH, seed=22)
        have_h5 = importlib.util.find_spec("h5py") is not None
        if have_h5:
            write_h5_corpus(os.path.join(tmp.name, "train_h5"), train_b)
            write_h5_corpus(os.path.join(tmp.name, "valid_h5"), valid_b)
        else:
            log("train: h5 reader not exercised on the card: h5py is not installed on this "
                "machine; the epoch cycle (run_epochs) runs on the same batches in memory")
        window = (np.random.RandomState(23).randn(1, 48000) * 0.2).astype(np.float32)
        for compute_dtype, dtype in dtypes.items():
            fast = dtype == torch.bfloat16
            out = os.path.join(tmp.name, f"runs_{compute_dtype}")
            t0 = time.perf_counter()
            if have_h5:
                (model_dir, hist), counts = main_path(lambda: loop.train(
                    os.path.join(tmp.name, "train_h5"), os.path.join(tmp.name, "valid_h5"), out,
                    num_epochs=1, train_epoch_size=4, validation_epoch_size=2,
                    train_batch_size=TRAIN_BATCH, validation_batch_size=TRAIN_BATCH,
                    model_type=TRAIN_MODEL, compute_dtype=compute_dtype, checkpoint_interval=1,
                    disable_logging=True, device=dev))
                expected = {"config.json", "model.json"}
            else:
                model_dir = os.path.join(out, "run")
                os.makedirs(model_dir)
                state = create_train_state(spec, torch.Generator().manual_seed(20), 1e-4, dtype, dev)
                (hist, preempted), counts = main_path(lambda: loop.run_epochs(
                    state, make_train_step(), make_eval_step(), model_dir,
                    itertools.cycle(train_b), lambda: iter(valid_b),
                    num_epochs=1, train_epoch_size=4, validation_epoch_size=2,
                    train_batch_size=TRAIN_BATCH, checkpoint_interval=1))
                assert not preempted
                expected = set()
            wall = time.perf_counter() - t0
            expected |= {checkpoints.LATEST, checkpoints.BEST_VALID_ACC, checkpoints.BEST_VALID_LOSS,
                         checkpoints.PERIODIC_FMT.format(epoch=0), "history_csvlog.csv",
                         "history_checkpoint.pkl", "history.pkl"}
            files = set(os.listdir(model_dir))
            if files != expected:
                raise SystemExit(f"train {compute_dtype}: run dir holds {sorted(files)}, want {sorted(expected)}")
            with open(os.path.join(model_dir, "history.pkl"), "rb") as f:
                saved = pickle.load(f)
            row = [saved[k][0] for k in ("loss", "acc", "val_loss", "val_acc")]
            if not np.isfinite(row).all():
                raise SystemExit(f"train {compute_dtype}: non-finite history {row}")
            kernel = f"mel_frontend_{'bf16' if fast else 'f32'}"
            if counts[kernel] < 1:
                raise SystemExit(f"train {compute_dtype} did not go through {kernel}")
            ckpt = os.path.join(model_dir, checkpoints.BEST_VALID_LOSS)
            log(f"train {TRAIN_MODEL} {compute_dtype} batch {TRAIN_BATCH}: 4 steps + 2 eval, "
                f"wall {wall:.2f} s (epoch {saved['epoch_times'][0]:.2f} s), loss {row[0]:.4f} "
                f"acc {row[1]:.3f} val_loss {row[2]:.4f} val_acc {row[3]:.3f}, launches {dict(counts)}, "
                f"data wait {1e3 * np.mean(saved['data_wait_times']):.3f} ms/step (first "
                f"{1e3 * saved['data_wait_times'][0]:.3f}), checkpoints {1e3 * saved['checkpoint_times'][0]:.1f} ms "
                f"for 4 files of {os.path.getsize(ckpt) / 1e6:.1f} MB, files {sorted(files)}")
            ext = EmbeddingExtractor(ckpt, TRAIN_MODEL, "short", fast=fast, device=dev)
            emb, counts = main_path(lambda: ext.embed_windows(window))
            cpu = EmbeddingExtractor(ckpt, TRAIN_MODEL, "short", fast=fast, device="cpu").embed_windows(window)
            cos = row_cosines(torch.from_numpy(emb), torch.from_numpy(cpu)).min().item()
            gate = 0.999 if fast else 0.9999
            log(f"train {compute_dtype}: {checkpoints.BEST_VALID_LOSS} → EmbeddingExtractor: {emb.shape}, "
                f"cosine vs CPU extractor {cos:.7f} (>= {gate}), launches {dict(counts)}")
            if emb.shape != (1, 512) or not np.isfinite(emb).all() or cos < gate or counts[kernel] < 1:
                raise SystemExit(f"train {compute_dtype}: the trained checkpoint does not embed right")

        # One step on the card against the same step on a CPU copy.
        batch = avc_batches(1, CMP_BATCH, seed=24)[0]
        noise = bn_fed_biases(TRAIN_MODEL)
        ref = {}
        for compute_dtype, dtype in dtypes.items():
            ref[compute_dtype] = one_train_step(dtype, "cpu", batch)
        for compute_dtype, dtype in dtypes.items():
            fast = dtype == torch.bfloat16
            card = one_train_step(dtype, dev, batch, tf32_probe=True)
            m, grads, _, _ = card
            m_cpu, g_cpu, _, _ = ref[compute_dtype]
            ok, loss_rel, bn_cos, stat_err = step_agreement(
                f"train step card vs CPU {compute_dtype} batch {CMP_BATCH}", card, ref[compute_dtype], noise, not fast)
            if fast:
                # bf16 gradients stray from f32 ones by chance, leaf by leaf
                # (PERF.md §6, training): the card's bf16 step is held to be
                # no farther from the CPU's f32 step than 1.5x the CPU's bf16
                # step, and its batch statistics within 2e-2 of the CPU's
                # bf16 ones (the gates of tests/test_torch_port_train.py).
                g32 = ref["float32"][1]
                d_card = np.mean([1 - c for c in leaf_cosines(grads, g32, skip=noise).values()])
                d_cpu = np.mean([1 - c for c in leaf_cosines(g_cpu, g32, skip=noise).values()])
                log(f"train step bf16: mean gradient distance from the CPU f32 step, card {d_card:.4f}, "
                    f"CPU bf16 {d_cpu:.4f} (card <= 1.5x)")
                ok = (loss_rel <= 1e-2 and d_card <= 1.5 * d_cpu and stat_err <= 2e-2
                      and min(bn_cos.values()) >= 0.999 and m["acc"] == m_cpu["acc"])
            if not ok:
                raise SystemExit(f"train step {compute_dtype}: the card disagrees with the CPU")

        # Learning signal: 10 steps on one fixed batch.
        fixed = {k: torch.from_numpy(v).to(dev) for k, v in avc_batches(1, TRAIN_BATCH, seed=25)[0].items()}
        state = create_train_state(spec, torch.Generator().manual_seed(6), 1e-4, torch.float32, dev)
        step = make_train_step()
        losses = []
        for _ in range(10):
            state, m = step(state, fixed)
            losses.append(float(m["loss"] + m["reg_loss"]))
        log(f"train f32 10 steps on one batch of {TRAIN_BATCH}: loss {' '.join(f'{x:.4f}' for x in losses)}")
        if not losses[-1] < losses[0]:
            raise SystemExit("train: the loss on a fixed batch did not fall")
        del state

        # Step time, pairs/s and peak memory at batch 64, then a profile.
        big = {k: torch.from_numpy(v).to(dev) for k, v in avc_batches(1, TIMING_BATCH, seed=26)[0].items()}
        for compute_dtype, dtype in dtypes.items():
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            state = create_train_state(spec, torch.Generator().manual_seed(7), 1e-4, dtype, dev)
            times = []
            for i in range(12):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = step(state, big)
                torch.cuda.synchronize()
                if i >= 2:
                    times.append((time.perf_counter() - t0) * 1e3)
            med = statistics.median(times)
            peak = torch.cuda.max_memory_allocated() / 2**30
            log(f"train step {TRAIN_MODEL} {compute_dtype} batch {TIMING_BATCH}: median {med:.3f} ms "
                f"(min {min(times):.3f}, max {max(times):.3f}, 10 steps after 2), "
                f"{TIMING_BATCH * 1e3 / med:.1f} pairs/s, peak memory {peak:.2f} GiB, loss {float(m['loss']):.4f}")
            reps = 3
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(reps):
                    state, m = step(state, big)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3 / reps
            log_profile(f"profile train {compute_dtype} batch {TIMING_BATCH}", prof, reps, wall_ms,
                        f"{TIMING_BATCH * 1e3 / wall_ms:.1f} pairs/s under the profiler", "step")
            if dtype == torch.float32:
                trained = checkpoints.state_tree(state)  # host copies: the bf16 peak stays its own
            del state, prof
            log(f"train timing {compute_dtype} on: " + subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw",
                 "--format=csv,noheader"], capture_output=True, text=True, check=True).stdout.strip())
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev_tf32
        tmp.cleanup()
    return trained


SAMPLE_CLIPS = 24  # AudioSet clips; a real subset has 10^5-10^6
SAMPLE_SECONDS = 10  # AudioSet's clip length
SAMPLE_FPS = 30
SAMPLE_FRAME = (256, 340)  # the ffmpeg reader's 256 px short side
SAMPLE_SR = 48000
# 02's defaults (batch 64, -ns 64, mux rate 2.0, one distractor) with
# --augment --include-metadata; the mux's 64 streamers are clamped to the
# train split's seeds.
SAMPLE_ARGS = dict(batch_size=64, k=64, rate=2.0, num_distractors=1, augment=True, include_metadata=True)
SAMPLE_TIMED = 4  # factory batches timed after a first one
SAMPLE_PROCS = 4
SAMPLE_STEPS = 16  # train steps timed on factory batches, after 2


def sample_corpus(root: str, seed: int) -> None:
    """SAMPLE_CLIPS clips in the layout 01 reads, made in bulk from a seed:
    audio/<ytid>_0_10.wav (10 s of int16 at 48 kHz) and video/<ytid>_0_10.npy
    (300 frames of 256×340×3 uint8, ~78 MB, memory-mapped by read_video)."""
    from l3embedding_torch.data.audio_io import write_wav

    rng = np.random.default_rng(seed)
    for d in ("audio", "video"):
        os.makedirs(os.path.join(root, d))
    for i in range(SAMPLE_CLIPS):
        name = f"clip{i:02d}_0_10"
        frames = rng.integers(0, 256, (SAMPLE_SECONDS * SAMPLE_FPS, *SAMPLE_FRAME, 3), dtype=np.uint8)
        np.save(os.path.join(root, "video", name + ".npy"), frames)
        audio = (rng.standard_normal(SAMPLE_SECONDS * SAMPLE_SR) * 3000).astype(np.int16)
        write_wav(os.path.join(root, "audio", name + ".wav"), audio, SAMPLE_SR)


def factory_rate(index: int, subset: str, seed: int, batches: int, augment: bool = True) -> tuple[int, float, float]:
    """One factory stream (02's sampling, seeded seed + index) → (samples in
    the timed batches, their seconds, the seconds of the first batch, which
    opens the streamers). Module level, so a spawned worker can run it."""
    from l3embedding_torch.data import sample as S

    gen = S.data_generator(subset, random_state=seed + index, **{**SAMPLE_ARGS, "augment": augment})
    t0 = time.perf_counter()
    next(gen)
    t1 = time.perf_counter()
    for _ in range(batches):
        next(gen)
    return batches * SAMPLE_ARGS["batch_size"], time.perf_counter() - t1, t1 - t0


def check_factory_batch(batch: dict, paths: dict, full: bool) -> None:
    """Shapes and dtypes; each label against its two metadata file names;
    the crop, frame and audio-start bounds and the gain range. With `full`,
    each row is also made again from its sources and its metadata: the
    audio is the source slice at audio_start_sample_idx × audio_gain, and
    the frame the native augmentation of the recorded crop, in one of the
    two orders."""
    from l3embedding_torch import native
    from l3embedding_torch.data.audio_io import read_audio, to_mono_int16
    from l3embedding_torch.data.video_io import read_video

    n = SAMPLE_ARGS["batch_size"]
    want = {"audio": ((n, 1, SAMPLE_SR), np.int16), "video": ((n, 224, 224, 3), np.uint8),
            "label": ((n, 2), np.int64)}
    for k, (shape, dtype) in want.items():
        if batch[k].shape != shape or batch[k].dtype != dtype:
            raise SystemExit(f"sample: {k} is {batch[k].shape} {batch[k].dtype}, want {shape} {dtype}")
    stem = lambda b: os.path.splitext(b.decode())[0]  # noqa: E731
    match = np.array([stem(a) == stem(v) for a, v in zip(batch["audio_file"], batch["video_file"])])
    if not (np.array_equal(batch["label"][:, 1], match) and np.array_equal(batch["label"][:, 0], ~match)):
        raise SystemExit("sample: a label disagrees with its audio and video file names")
    x, y = batch["video_bounding_box_start_x"], batch["video_bounding_box_start_y"]
    frame0 = (batch["audio_start_sample_idx"] / float(SAMPLE_SR) * SAMPLE_FPS).astype(int)  # as the sampler
    ok = ((x >= 0).all() and (x < SAMPLE_FRAME[0] - 224).all() and (y >= 0).all()
          and (y < SAMPLE_FRAME[1] - 224).all()
          and (batch["audio_start_sample_idx"] >= 0).all()
          and (batch["audio_start_sample_idx"] < (SAMPLE_SECONDS - 1) * SAMPLE_SR).all()
          and (batch["video_start_frame_idx"] >= frame0).all()
          and (batch["video_start_frame_idx"] < frame0 + SAMPLE_FPS).all()
          and ((batch["audio_gain"] >= 0.9) & (batch["audio_gain"] <= 1.1)).all())
    if not ok:
        raise SystemExit("sample: a crop, frame, audio start or gain is out of its bounds")
    if not full:
        return
    audio = {}
    for i in range(n):
        a, v = batch["audio_file"][i].decode(), batch["video_file"][i].decode()
        if a not in audio:
            audio[a] = to_mono_int16(read_audio(paths[a])[0])
        s0 = int(batch["audio_start_sample_idx"][i])
        want_audio = (audio[a][s0:s0 + SAMPLE_SR].astype(float) * batch["audio_gain"][i]).astype(np.int16)
        frame = read_video(paths[v])[batch["video_start_frame_idx"][i]]
        crop = frame[x[i]:x[i] + 224, y[i]:y[i] + 224]
        args = (bool(batch["video_horizontal_flip"][i]), float(batch["video_saturation_factor"][i]),
                float(batch["video_brightness_delta"][i]))
        frames = [native.augment_frame(crop, *args, sat_first=order) for order in (True, False)]
        if not np.array_equal(batch["audio"][i, 0], want_audio) or not any(
                np.array_equal(batch["video"][i], f) for f in frames):
            raise SystemExit(f"sample: row {i} is not made from its sources and its metadata")


def phase_sample(dev, trained) -> None:
    """The AVC sample factory (stages 01 and 02, the native host library)
    feeding the trainer, and directory checkpoints. A seeded corpus of 24
    AudioSet-length clips (10 s; video as .npy at 30 fps, 256×340, ~1.9 GB;
    int16 WAV at 48 kHz) in a temporary directory; the port's 01 function
    splits it; 02's sampling (batch 64, 64 streamers, rate 2.0, --augment,
    --include-metadata, one distractor) makes batches, each checked (shapes,
    labels against the metadata, bounds; the first made again from its
    sources) and the first drawn twice from one seed; the factory's
    samples/s in one process (native augmentation, numpy augmentation, none)
    and in 4 processes through map_iterate_in_parallel; the native
    augment_frame against its numpy plain version on 64 frames;
    cnn_L3_melspec2 at full width trained on the factory's stream, f32 and
    bf16, through AsyncBatchPipeline → to_device → the train step (steps/s,
    data wait per step, the device's idle share), and one f32 step at batch
    4 on a factory batch against a CPU copy; the 02 CLI and train() over its
    files where h5py is installed; and `trained` (phase_train's f32 state, a
    ``state_tree``) put on the card and through save_state_dir /
    load_state_dir, every leaf bit for bit."""
    import collections
    import contextlib
    import csv
    import functools
    import importlib.util
    import tempfile
    from unittest import mock

    from torch.profiler import ProfilerActivity, profile

    from l3embedding_torch import native
    from l3embedding_torch.cli.create_subsets import create_subsets
    from l3embedding_torch.compat.from_jax import bn_fed_biases
    from l3embedding_torch.data import sample as S
    from l3embedding_torch.data.utils import map_iterate_in_parallel
    from l3embedding_torch.data.video_io import read_video
    from l3embedding_torch.models.registry import build_model
    from l3embedding_torch.training import checkpoints, loop
    from l3embedding_torch.training.data import DEFAULT_KEYS, AsyncBatchPipeline, to_device
    from l3embedding_torch.training.dir_checkpoints import load_state_dir, save_state_dir
    from l3embedding_torch.training.state import create_train_state
    from l3embedding_torch.training.steps import make_train_step

    if not native.available():
        raise SystemExit("sample: the native host library is not available")
    tmp = tempfile.TemporaryDirectory()
    try:
        root = os.path.join(tmp.name, "corpus")
        t0 = time.perf_counter()
        sample_corpus(root, seed=40)
        size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)
        log(f"sample corpus: {SAMPLE_CLIPS} clips of {SAMPLE_SECONDS} s ({size / 1e9:.2f} GB: .npy video "
            f"{SAMPLE_FPS} fps {SAMPLE_FRAME[0]}x{SAMPLE_FRAME[1]}, int16 WAV {SAMPLE_SR} Hz) made in "
            f"{time.perf_counter() - t0:.1f} s; cuts: {SAMPLE_CLIPS} clips where a real subset has 10^5-10^6, "
            f"the mux's {SAMPLE_ARGS['k']} streamers clamped to the train split's seeds")

        # 01: the three CSVs partition the clips.
        paths = create_subsets(root, os.path.join(tmp.name, "subsets"), "smoke")
        parts = []
        for p in paths:
            with open(p) as f:
                parts.append([r["ytid"] for r in csv.DictReader(f)])
        every = sorted(f"clip{i:02d}" for i in range(SAMPLE_CLIPS))
        log(f"sample 01: train / valid / test {[len(p) for p in parts]} clips")
        if sorted(sum(parts, [])) != every or not all(parts):
            raise SystemExit(f"sample 01: the subsets do not partition the clips: {parts}")
        train_csv = paths[0]
        with open(train_csv) as f:
            files = {os.path.basename(r[k]): r[k] for r in csv.DictReader(f)
                     for k in ("audio_filepath", "video_filepath")}

        # 02's sampling: every batch checked, one seed draws one first batch.
        batches = [b for b, _ in zip(S.data_generator(train_csv, random_state=41, **SAMPLE_ARGS), range(3))]
        for i, b in enumerate(batches):
            check_factory_batch(b, files, full=i == 0)
        again = next(S.data_generator(train_csv, random_state=41, **SAMPLE_ARGS))
        same = sorted(again) == sorted(batches[0]) and all(np.array_equal(again[k], batches[0][k]) for k in again)
        log(f"sample 02: {len(batches)} batches of {SAMPLE_ARGS['batch_size']}, keys {sorted(batches[0])}, "
            f"labels {batches[0]['label'].dtype} one-hot ({int(batches[0]['label'][:, 1].sum())} matched in the "
            f"first); shapes, labels against the file names and bounds checked, the first batch made again "
            f"from its sources; the same seed draws the same first batch: {same}")
        if not same:
            raise SystemExit("sample 02: one seed drew two different first batches")

        # The factory's rate: one process three ways, then 4 processes.
        rates = {}
        for name, augment, plain in (("augment native", True, False), ("augment numpy", True, True),
                                     ("no augmentation", False, False)):
            with mock.patch.object(native, "_load", lambda: None) if plain else contextlib.nullcontext():
                n, secs, first = factory_rate(0, train_csv, 42, SAMPLE_TIMED, augment)
            rates[name] = n / secs
            log(f"sample factory, 1 process, {name}: {rates[name]:.1f} samples/s ({n} samples in {secs:.3f} s, "
                f"after a first batch of {first:.3f} s)")
        t0 = time.perf_counter()
        res = map_iterate_in_parallel(range(SAMPLE_PROCS), functools.partial(
            factory_rate, subset=train_csv, seed=43, batches=SAMPLE_TIMED), processes=SAMPLE_PROCS)
        wall = time.perf_counter() - t0
        total = sum(n for n, _, _ in res) + SAMPLE_PROCS * SAMPLE_ARGS["batch_size"]
        rates["4 processes"] = sum(n / secs for n, secs, _ in res)
        log(f"sample factory, {SAMPLE_PROCS} spawned processes, augment native: {rates['4 processes']:.1f} "
            f"samples/s (the workers' timed batches, summed); {total / wall:.1f} samples/s over the call's "
            f"{wall:.2f} s, start-up included; per worker "
            f"{', '.join(f'{n / secs:.1f}' for n, secs, _ in res)}")

        # The native augment_frame against its numpy plain version.
        rng = np.random.RandomState(44)
        video = read_video(sorted(v for v in files.values() if v.endswith(".npy"))[0])
        diffs, t_native, t_plain = [], 0.0, 0.0
        for _ in range(64):
            x, y = rng.randint(SAMPLE_FRAME[0] - 224), rng.randint(SAMPLE_FRAME[1] - 224)
            crop = np.ascontiguousarray(video[rng.randint(len(video))][x:x + 224, y:y + 224])
            args = (rng.rand() < 0.5, float(np.float32(rng.rand() + 0.5)),
                    float(np.float32((2 * rng.rand() - 1) * 32 / 255)), rng.rand() < 0.5)
            t0 = time.perf_counter()
            got = native.augment_frame(crop, *args)
            t1 = time.perf_counter()
            want = native.augment_frame_plain(crop, *args)
            t_plain += time.perf_counter() - t1
            t_native += t1 - t0
            diffs.append(np.abs(got.astype(int) - want.astype(int)))
        diffs = np.stack(diffs)
        log(f"sample augment_frame, native against numpy on 64 frames of 224x224: max |d| {diffs.max()} LSB "
            f"(<= 1), {100 * (diffs > 0).mean():.3f} % of pixels differ (< 2 %); {1e3 * t_native / 64:.3f} ms "
            f"a frame native, {1e3 * t_plain / 64:.3f} ms numpy")
        if diffs.max() > 1 or (diffs > 0).mean() >= 0.02:
            raise SystemExit("sample: the native augment_frame disagrees with its numpy plain version")

        # Train on the factory's stream: the trainer's feed, f32 and bf16.
        spec = build_model(TRAIN_MODEL)
        step = make_train_step()
        for compute_dtype, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            kernel = f"mel_frontend_{'bf16' if dtype == torch.bfloat16 else 'f32'}"
            state = create_train_state(spec, torch.Generator().manual_seed(45), 1e-4, dtype, dev)
            feed = (to_device({k: b[k] for k in DEFAULT_KEYS}, dev)
                    for b in S.data_generator(train_csv, random_state=46, **SAMPLE_ARGS))

            def run():
                nonlocal state
                waits, starts, losses = [], [], collections.deque()
                with AsyncBatchPipeline(feed) as pipe:
                    for _ in range(2):
                        state, m = step(state, next(pipe))
                    float(m["loss"])
                    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
                        t0 = time.perf_counter()
                        for _ in range(SAMPLE_STEPS):
                            starts.append(time.perf_counter())
                            batch = next(pipe)
                            waits.append(time.perf_counter() - starts[-1])
                            state, m = step(state, batch)
                            losses.append(m["loss"])
                            if len(losses) > 8:  # the loop's window of steps in flight
                                float(losses.popleft())
                        torch.cuda.synchronize()
                        wall = time.perf_counter() - t0
                return waits, starts, [float(x) for x in losses], wall, prof

            (waits, starts, losses, wall, prof), counts = main_path(run)
            # The queue holds up to 4 batches made during the first 2 steps:
            # the last 8 steps' interval is the steady rate.
            steady = (starts[-1] - starts[-9]) / 8
            log(f"sample train {TRAIN_MODEL} {compute_dtype} batch {SAMPLE_ARGS['batch_size']} on the factory's "
                f"stream: {SAMPLE_STEPS / wall:.3f} steps/s ({SAMPLE_STEPS * SAMPLE_ARGS['batch_size'] / wall:.1f} "
                f"pairs/s, {1e3 * wall / SAMPLE_STEPS:.1f} ms a step; the last 8 steps {1e3 * steady:.1f} ms a step, "
                f"{SAMPLE_ARGS['batch_size'] / steady:.1f} pairs/s), data wait {1e3 * np.mean(waits):.1f} ms a step "
                f"(last 8 steps {1e3 * np.mean(waits[-8:]):.1f}, max {1e3 * max(waits):.1f}), last losses "
                f"{' '.join(f'{x:.4f}' for x in losses[-3:])}, launches {dict(counts)}")
            log_profile(f"profile sample train {compute_dtype}", prof, SAMPLE_STEPS, 1e3 * wall / SAMPLE_STEPS,
                        f"{SAMPLE_STEPS / wall:.3f} steps/s", "step")
            if counts[kernel] < SAMPLE_STEPS + 2 or not np.isfinite(losses).all():
                raise SystemExit(f"sample train {compute_dtype}: {counts[kernel]} {kernel} launches, losses {losses}")
            del state, prof

        # One f32 step at batch 4 on a factory batch, card against a CPU copy.
        small = {k: batches[0][k][:CMP_BATCH] for k in DEFAULT_KEYS}
        card = one_train_step(torch.float32, dev, small, tf32_probe=True)
        cpu = one_train_step(torch.float32, "cpu", small)
        ok = step_agreement(f"sample train step card vs CPU float32 batch {CMP_BATCH} (a factory batch)", card, cpu,
                            bn_fed_biases(TRAIN_MODEL), True)[0]
        if not ok:
            raise SystemExit("sample train step: the card disagrees with the CPU on a factory batch")

        # The 02 CLI and train() over its files, where h5py is installed.
        if importlib.util.find_spec("h5py") is not None:
            out = os.path.join(tmp.name, "cli_h5")
            t0 = time.perf_counter()
            rc = subprocess.run([sys.executable, "-m", "l3embedding_torch.cli.generate_samples", "-n", "4",
                                 "-bs", "16", "-a", "-im", train_csv, "128", out], cwd=REPO, timeout=600).returncode
            n_files = len(os.listdir(out)) if os.path.isdir(out) else 0
            (_, hist), counts = main_path(lambda: loop.train(
                out, out, os.path.join(tmp.name, "cli_run"), num_epochs=1, train_epoch_size=2,
                validation_epoch_size=1, train_batch_size=16, validation_batch_size=16, model_type=TRAIN_MODEL,
                compute_dtype="float32", disable_logging=True, device=dev))
            row = [hist[k][0] for k in ("loss", "acc", "val_loss", "val_acc")]
            log(f"sample 02 CLI -n 4: rc {rc}, {n_files} files in {time.perf_counter() - t0:.1f} s with train() "
                f"over them: {row}, launches {dict(counts)}")
            if rc != 0 or n_files != 8 or not np.isfinite(row).all() or counts["mel_frontend_f32"] < 1:
                raise SystemExit("sample: the 02 CLI or train() over its files failed")
        else:
            log("sample 02 CLI and train() over its files: skipped, h5py is not installed on this machine (the "
                "CLI writes h5 files); the factory's batches went to the trainer in memory above")

        # Directory checkpoints of phase_train's full-width f32 state.
        state = checkpoints.load_state_tree(trained, create_train_state(
            spec, torch.Generator().manual_seed(49), 1e-4, torch.float32, dev))
        snap = os.path.join(tmp.name, "snap")
        t0 = time.perf_counter()
        save_state_dir(snap, state)
        t_save = time.perf_counter() - t0
        other = create_train_state(spec, torch.Generator().manual_seed(47), 1e-4, torch.float32, dev)
        t0 = time.perf_counter()
        load_state_dir(snap, other)
        t_load = time.perf_counter() - t0
        ckpt = os.path.join(tmp.name, "state.ckpt")
        t0 = time.perf_counter()
        checkpoints.save_state(ckpt, state)
        t_ckpt = time.perf_counter() - t0
        t0 = time.perf_counter()
        checkpoints.load_state(ckpt, create_train_state(spec, torch.Generator().manual_seed(48), 1e-4,
                                                        torch.float32, dev))
        t_ckpt_load = time.perf_counter() - t0
        got = checkpoints.state_tree(other)

        def leaves(tree, prefix=""):
            for k, v in tree.items():
                yield from leaves(v, f"{prefix}{k}/") if isinstance(v, dict) else [(prefix + k, v)]

        want, got = dict(leaves(trained)), dict(leaves(got))
        bad = [k for k in want if k not in got or want[k].dtype != got[k].dtype or not np.array_equal(want[k], got[k])]
        size = sum(os.path.getsize(os.path.join(snap, f)) for f in os.listdir(snap))
        log(f"sample dir checkpoint {TRAIN_MODEL} f32 (step {state.step}): {len(want)} leaves, "
            f"{size / 1e6:.1f} MB in {sorted(os.listdir(snap))}; save_state_dir {t_save:.3f} s, load_state_dir "
            f"{t_load:.3f} s; save_state (.ckpt, {os.path.getsize(ckpt) / 1e6:.1f} MB) {t_ckpt:.3f} s, load_state "
            f"{t_ckpt_load:.3f} s; leaves not bit-equal after the round trip: {bad}")
        if bad or set(got) != set(want) or other.step != state.step:
            raise SystemExit("sample: the directory checkpoint did not restore every leaf bit for bit")
    finally:
        tmp.cleanup()


def audio_windows(n: int, seed: int, seconds: float = 1.0) -> np.ndarray:
    """Audio-like windows (summed random tones + noise, each peak-normalised)."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * 48000)) / 48000
    tones = rng.rand(n, 4, 1) * np.sin(2 * np.pi * rng.uniform(50, 8000, (n, 4, 1)) * t + rng.rand(n, 4, 1) * 6.28)
    x = tones.sum(1) + 0.1 * rng.randn(n, t.size)
    return (x / (np.abs(x).max(1, keepdims=True) + 1e-9)).astype(np.float32)


def rate(fn, n: int, reps: int = 3) -> float:
    """n / (host-clock seconds of one fn call, mean of `reps` after a warm-up)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return n * reps / (time.perf_counter() - t0)


def phase_int8(dev):
    """Int8 extraction on cnn_L3_melspec2 'short' at full width: the seeded
    tower folded and calibrated (amax) on 64 windows, 64 held-out windows
    embedded with the int8 DFT on and off (and profiled), the min cosine against the folded
    f32 tower on the card (>= 0.999), the card's rows against the CPU port's
    from the same artifact, an artifact saved and loaded (identical rows),
    embed_file on the 10.3 s WAV with and without device framing (identical
    rows), the HTTP server on --int8-artifact answering /v1/embed_windows;
    windows/s of int8 (each DFT mode), bf16 and f32 at B = 64; the int8 DFT
    product (torch._int_mm) and front end timed; then cnn_L3_melspec1 and
    cnn_L3_orig calibrated and gated at 16 windows."""
    import tempfile
    import urllib.request

    from l3embedding_torch.embed import http_serve
    from l3embedding_torch.embed.extract import EmbeddingExtractor
    from l3embedding_torch.embed.quantized import QuantizedEmbeddingExtractor
    from l3embedding_torch.ops import frontend, mel_kernel

    tmp = tempfile.TemporaryDirectory()
    cal, held = audio_windows(BATCH, seed=31), audio_windows(BATCH, seed=32)
    exts, rows = {}, {}
    for dft in (True, False):
        ext = QuantizedEmbeddingExtractor(None, "cnn_L3_melspec2", "short", dft_int8=dft, device=dev)
        if dft:
            amax, counts = main_path(lambda: ext.q.calibrate(cal))
            log(f"int8 melspec2: calibrated on {BATCH} windows (amax per conv input "
                f"{np.array2string(amax, precision=3)}), launches {dict(counts)}")
            if counts["mel_frontend_bf16"] < 1:
                raise SystemExit("int8 calibration did not run on the bf16 front-end kernel")
        else:
            ext.q._set_scales(exts[True].q._act_scales)
        rows[dft], counts = main_path(lambda: ext.embed_windows(held))
        want_front = "mel_frontend_bf16" if not dft else None
        if counts["int8_conv_s8"] != 8 or (want_front and counts[want_front] < 1) or not np.isfinite(rows[dft]).all():
            raise SystemExit(f"int8 melspec2 dft_int8={dft}: launches {dict(counts)}, or rows not finite")
        cmin, cmean = ext.q.embedding_cosine(held)
        ext.calib_cosine = (cmin, cmean)
        log(f"int8 melspec2 dft_int8={dft}: {rows[dft].shape}, launches {dict(counts)}; cosine against the "
            f"folded f32 tower on the card: min {cmin:.7f} (>= 0.999), mean {cmean:.7f}")
        if cmin < 0.999 or rows[dft].shape != (BATCH, 512):
            raise SystemExit(f"int8 melspec2 dft_int8={dft} misses the 0.999 gate")
        exts[dft] = ext

    ext = exts[True]
    art = os.path.join(tmp.name, "melspec2.int8.npz")
    ext.save_artifact(art)
    loaded = QuantizedEmbeddingExtractor.load_artifact(art, device=dev)
    again, counts = main_path(lambda: loaded.embed_windows(held))
    log(f"int8 artifact ({os.path.getsize(art) / 1e6:.1f} MB) saved and loaded: rows identical "
        f"{np.array_equal(again, rows[True])}, launches {dict(counts)}")
    if not np.array_equal(again, rows[True]):
        raise SystemExit("int8: the loaded artifact's rows differ")
    cpu = QuantizedEmbeddingExtractor.load_artifact(art, device="cpu")
    check_rows("int8 melspec2: card rows against the CPU port's from the same artifact (4 windows)",
               rows[True][:4], cpu.embed_windows(held[:4]), 0.9999)

    wav = os.path.join(tmp.name, "clip.wav")
    fixture_wav(wav, 10.3, 44100, seed=11)
    framed = {}
    for framing in (True, False):
        loaded.device_framing = framing
        framed[framing], counts = main_path(lambda: loaded.embed_file(wav))
        if counts["int8_conv_s8"] < 1:
            raise SystemExit(f"int8 embed_file device_framing={framing} did not launch int8_conv")
    same = np.array_equal(framed[True], framed[False])
    log(f"int8 embed_file 10.3 s WAV: {framed[True].shape}, device framing against host framing identical {same}")
    if not same:
        check_rows("int8 embed_file: device framing against host framing", framed[True], framed[False], 0.99999)

    def http():
        srv = http_serve.make_server(http_serve.build_extractor(http_serve.parse_args(
            ["--int8-artifact", art, "--device", dev])), "127.0.0.1", 0, max_latency_ms=5.0)
        http_serve.serve_forever_in_thread(srv)
        try:
            host, port = srv.server_address[:2]
            req = urllib.request.Request(f"http://{host}:{port}/v1/embed_windows", data=held[:3].tobytes(),
                                         headers={"X-Num-Windows": "3"})
            with urllib.request.urlopen(req) as r:
                return np.frombuffer(r.read(), "<f4").reshape(3, int(r.headers["X-Embedding-Dim"]))
        finally:
            srv.shutdown()
            srv.l3_service.close()
            srv.server_close()

    served, counts = main_path(http)
    log(f"int8 http --int8-artifact: /v1/embed_windows {served.shape}, launches {dict(counts)}")
    if counts["int8_conv_s8"] < 1:
        raise SystemExit("int8 http did not launch int8_conv")
    check_rows("int8 http /v1/embed_windows against embed_windows", served, rows[True][:3], 0.99999)

    rates = {}
    for name, e in (("int8 dft_int8=True", exts[True]), ("int8 dft_int8=False", exts[False]),
                    ("bf16", EmbeddingExtractor(None, "cnn_L3_melspec2", "short", fast=True, device=dev)),
                    ("f32", EmbeddingExtractor(None, "cnn_L3_melspec2", "short", device=dev))):
        rates[name] = rate(lambda: e.embed_windows(held), BATCH)
    log("int8 melspec2 windows/s at B=64 (host clock, mean of 3 after a warm-up): " +
        ", ".join(f"{k} {v:.1f}" for k, v in rates.items()))
    from torch.profiler import ProfilerActivity, profile

    for dft in (True, False):
        reps = 3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                exts[dft].embed_windows(held)
            wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        log_profile(f"profile int8 melspec2 dft_int8={dft}", prof, reps, wall_ms,
                    f"{BATCH * 1e3 / wall_ms:.1f} windows/s under the profiler", "call")

    x = torch.from_numpy(held).to(dev)
    cfg = frontend.MelConfig(n_mels=256)
    xq, _ = frontend.quantize_waveform(x)
    frames = frontend.frame_signal(xq, cfg.n_dft, cfg.hop, cfg.padding).reshape(-1, cfg.n_dft).contiguous()
    bank_t, _ = frontend.int8_bank_device(cfg.n_dft, str(x.device))
    m, k, n = frames.shape[0], frames.shape[1], bank_t.shape[0]
    mm_ms = cuda_ms(lambda: frontend.int8_dft_product(frames, bank_t))
    mm_bound = max(2.0 * m * k * n / PEAK_INT8_TC, (m * k + k * n + 4 * m * n) / PEAK_HBM) * 1e3
    fe_ms = cuda_ms(lambda: frontend.melspectrogram_int8dft(x, cfg))
    bf16_ms = cuda_ms(lambda: mel_kernel.melspectrogram_fused(x, cfg, fast=True))
    log(f"int8 DFT product torch._int_mm ({m}x{k}) x ({k}x{n}): {mm_ms:.4f} ms (CUDA events, 20 calls), bound "
        f"{mm_bound:.4f} ms; whole int8-DFT front end {fe_ms:.4f} ms; bf16 mel kernel {bf16_ms:.4f} ms")

    for model_type in ("cnn_L3_melspec1", "cnn_L3_orig"):
        e = QuantizedEmbeddingExtractor(None, model_type, "short", device=dev)
        e.q.calibrate(cal[:16])
        got, counts = main_path(lambda: e.embed_windows(held[:16]))
        cmin, cmean = e.q.embedding_cosine(held[:16])
        log(f"int8 {model_type} dft_int8={e.q.dft_int8}: {got.shape}, launches {dict(counts)}, cosine against "
            f"folded f32 min {cmin:.7f} (>= 0.999), mean {cmean:.7f}")
        if cmin < 0.999 or counts["int8_conv_s8"] != 8:
            raise SystemExit(f"int8 {model_type} misses the gate or its launches")
    del exts, loaded, x, frames
    torch.cuda.empty_cache()
    tmp.cleanup()


def corpus_fixture(root: str) -> tuple[str, str]:
    """A seeded cnn_L3_melspec2 checkpoint in the reference layout and a
    dcase2013 corpus (2 folds × 10 classes × 2 stdlib WAVs of 2.5 s)."""
    from l3embedding_torch.data.audio_io import write_wav
    from l3embedding_torch.models.registry import build_model
    from l3embedding_torch.training.checkpoints import save_variables

    model_dir = os.path.join(root, "models", "embedding", "music", "cnn_L3_melspec2", "20240101")
    os.makedirs(model_dir)
    model = build_model("cnn_L3_melspec2").module()
    model.reset_parameters(torch.Generator().manual_seed(0))
    ckpt = os.path.join(model_dir, "model_best_valid_accuracy.ckpt")
    save_variables(ckpt, model, "cnn_L3_melspec2")
    data = os.path.join(root, "dcase2013")
    rng = np.random.RandomState(41)
    t = np.arange(int(2.5 * 48000)) / 48000
    for fold in (1, 2):
        os.makedirs(os.path.join(data, f"fold{fold}"))
        for ci, cls in enumerate(("bus", "busystreet", "office", "openairmarket", "park", "quietstreet",
                                  "restaurant", "supermarket", "tube", "tubestation")):
            for idx in range(2):
                x = 0.4 * np.sin(2 * np.pi * (500.0 + 2300.0 * ci) * t) + 0.05 * rng.randn(t.size)
                write_wav(os.path.join(data, f"fold{fold}", f"{cls}{fold}{idx}.wav"), x, 48000)
    return ckpt, data


def phase_corpus(dev):
    """The port's 05 CLI in process on a seeded dcase2013 corpus (40 files of
    2.5 s), cnn_L3_melspec2 at full width, hop 0.1, 'original' pooling: f32,
    --fast, --int8 with --int8-save-artifact, then --int8-artifact on the
    saved file, all four twice in turns (the second round without one-time
    costs of the first). Every npz's X of the first round against the
    in-process extractor of its kind (f32 0.99999, bf16 0.999), the int8 run
    identical to the artifact run; files/s and windows/s of each run (host
    clock around the whole CLI). Returns the f32 run's (train, test) split,
    get_split's folds 2 and 1, for phase_classify."""
    import tempfile

    from l3embedding_torch.cli import generate_embedding_samples as cli
    from l3embedding_torch.data.usc.folds import get_split
    from l3embedding_torch.embed.extract import EmbeddingExtractor

    tmp = tempfile.TemporaryDirectory()
    ckpt, data = corpus_fixture(tmp.name)
    art = os.path.join(tmp.name, "corpus.int8.npz")
    runs = (("f32", [], "mel_frontend_f32"), ("bf16", ["--fast"], "mel_frontend_bf16"),
            ("int8", ["--int8", "--int8-save-artifact", art], "int8_conv_s8"),
            ("int8 artifact", ["--int8-artifact", art], "int8_conv_s8"))
    trees = {}
    for round_, (name, flags, kernel) in [(r, run) for r in (1, 2) for run in runs]:
        out = os.path.join(tmp.name, f"{name.replace(' ', '_')}_{round_}")
        t0 = time.perf_counter()
        rc, counts = main_path(lambda: cli.main(["-lmp", ckpt, "-hs", "0.1", "--device", dev, *flags,
                                                  "dcase2013", data, out]))
        wall = time.perf_counter() - t0
        tree = {}
        top = os.path.join(out, "features", "dcase2013", "l3", "original", "music", "cnn_L3_melspec2")
        for fold in sorted(os.listdir(top)):
            if fold.startswith("fold"):
                for f in sorted(os.listdir(os.path.join(top, fold))):
                    with np.load(os.path.join(top, fold, f)) as z:
                        tree[f"{fold}/{f}"] = (z["X"], int(z["y"]))
        windows = sum(x.shape[0] for x, _ in tree.values())
        log(f"corpus 05 {name} (round {round_}): rc {rc}, {len(tree)} files, {windows} windows in {wall:.2f} s "
            f"(the whole CLI: "
            f"load, {'calibration, ' if name == 'int8' else ''}extraction, npz writes): "
            f"{len(tree) / wall:.2f} files/s, {windows / wall:.1f} windows/s; launches {dict(counts)}")
        if rc != 0 or len(tree) != 40 or counts[kernel] < 1:
            raise SystemExit(f"corpus 05 {name}: rc {rc}, {len(tree)} files, {kernel} launches {counts[kernel]}")
        trees.setdefault(name, tree)
    for name, fast in (("f32", False), ("bf16", True)):
        ext = EmbeddingExtractor(ckpt, "cnn_L3_melspec2", "original", fast=fast, device=dev)
        worst = 1.0
        for key, (x, _) in trees[name].items():
            want = ext.embed_file(os.path.join(data, key.replace(".npz", ".wav")), hop_size=0.1)
            worst = min(worst, row_cosines(torch.from_numpy(x), torch.from_numpy(want)).min().item())
        log(f"corpus 05 {name}: every file's X against the in-process extractor: min cosine {worst:.7f} "
            f"(>= {GATES[fast]})")
        if worst < GATES[fast]:
            raise SystemExit(f"corpus 05 {name}: rows disagree with the in-process extractor")
    worst = min(row_cosines(torch.from_numpy(trees["bf16"][k][0]), torch.from_numpy(x)).min().item()
                for k, (x, _) in trees["f32"].items())
    same = all(np.array_equal(trees["int8"][k][0], x) and trees["int8"][k][1] == y
               for k, (x, y) in trees["int8 artifact"].items())
    int8_cos = min(row_cosines(torch.from_numpy(trees["int8"][k][0]), torch.from_numpy(x)).min().item()
                   for k, (x, _) in trees["f32"].items())
    log(f"corpus 05: bf16 against f32 min cosine {worst:.7f} (>= 0.999); int8 run identical to the artifact run "
        f"{same}; int8 against f32 min cosine {int8_cos:.7f}")
    key = sorted(trees["f32"])[0]
    for name in ("f32", "bf16", "int8"):
        x, y = trees[name][key]
        t0 = time.perf_counter()
        for _ in range(10):
            np.savez_compressed(io.BytesIO(), X=x, y=y)
        log(f"corpus 05 {name}: np.savez_compressed of one file's X {x.shape} {(time.perf_counter() - t0) * 100:.2f} "
            f"ms (host clock, mean of 10)")
    if worst < 0.999 or not same:
        raise SystemExit("corpus 05: bf16 misses the gate or the artifact run differs from the int8 run")
    # The f32 features go on to 06 (phase_classify): fold 2 trains, fold 1 tests.
    top = os.path.join(tmp.name, "f32_1", "features", "dcase2013", "l3", "original", "music", "cnn_L3_melspec2")
    train, _, test = get_split(top, 0, "dcase2013", valid=False)
    tmp.cleanup()
    return train, test


REPO = os.path.dirname(os.path.abspath(__file__))
DDP_BATCH = 8  # the global batch of the data-parallel check
DDP_TIMING_BATCH = 64  # rows per card in the scaling runs
# The vision input BN's bias gradient (3 values): the sum over every pixel
# of the first conv's input gradient, whose per-channel sums cancel through
# the BN after that conv. On these weights it is ill-conditioned in either
# package: scaling the input video by 1 ± 2^-22 moves its float64 value to
# cosine ~0.9998, and the f32 steps of the port and of JAX land 1e-4 to 2e-4
# from float64 as the input's last bits fall (PERF.md §6;
# tests/torch_port_bn_precision.py). It is held to 0.999, every other leaf
# to 0.9999, and its cosines to a float64 step on this card are logged.
DDP_CANCELLING_LEAF = "vision_model.input_bn.bias"


def run_ranks(nproc: int, args: list[str], timeout: float, cards: int) -> float:
    """``torch.distributed.run`` with nproc ranks of tools/dp_check on the
    first `cards` cards; the whole process group is killed if it outlives
    `timeout`. → wall s."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", f"--nproc-per-node={nproc}",
           "-m", "l3embedding_torch.tools.dp_check", *args]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES=",".join(map(str, range(cards))))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
            proc.wait()
    if proc.returncode != 0:
        log(out[-6000:])
        raise SystemExit(f"dp_check {args[0]} on {nproc} ranks exited {proc.returncode}")
    return time.perf_counter() - t0


def batch_stat_err(stats: dict, want: dict) -> float:
    """The largest relative error of a BN's batch statistics, read off the
    running ones of a fresh state's first step (mean 0 and variance 1
    before it; new = 0.99·old + 0.01·batch)."""
    batch = lambda s, n: (s[n] - (0.99 if n.endswith("var") else 0.0)) / 0.01  # noqa: E731
    return max(((batch(stats, n) - batch(want, n)).abs().max() / batch(want, n).abs().max()).item()
               for n in want)


def parallel_step_gates(what: str, name: str, m: dict, got: tuple, ref: dict, noise: dict, d_one: float) -> bool:
    """One step of several ranks (m: its metrics; got: its gathered
    (gradients, running statistics)) against ref[name], one process on the
    whole global batch (``one_train_step``'s result), at phase_ddp's gates.
    f32 (any name but "bf16"): the loss within 1e-5, the same accuracy,
    every gradient leaf at cosine >= 0.9999 but the BN-fed conv biases and
    DDP_CANCELLING_LEAF (>= 0.999; for "f32" logged against ref["f64"], a
    float64 step), BN batch statistics within 1e-3. bf16: the loss within
    1e-2, the same accuracy, the mean gradient distance from ref["f32"] at
    most 1.5x the one-process bf16 step's (d_one), batch statistics within
    2e-2. Logs one line; → passed."""
    m1 = ref[name][0]
    loss_rel = abs(m["loss"] - m1["loss"]) / abs(m1["loss"])
    cos = leaf_cosines(got[0], ref[name][1], skip=noise)
    ranked = sorted(cos, key=cos.get)
    worst = min((n for n in ranked if n != DDP_CANCELLING_LEAF), key=cos.get)
    stat_err = batch_stat_err(got[1], ref[name][2])
    line = (f"{what}: {name} step at global batch {DDP_BATCH} vs one process: loss {m['loss']:.6f} / "
            f"{m1['loss']:.6f} (rel {loss_rel:.2e}), acc {m['acc']:.3f} / {m1['acc']:.3f}, "
            f"gradient leaves min cosine {cos[worst]:.7f} ({worst}; {DDP_CANCELLING_LEAF} "
            f"{cos[DDP_CANCELLING_LEAF]:.7f}; lowest {[(n, round(cos[n], 7)) for n in ranked[:4]]}), "
            f"BN batch statistics max relative error {stat_err:.2e}")
    if name == "bf16":
        d = np.mean([1 - c for c in leaf_cosines(got[0], ref["f32"][1], skip=noise).values()])
        line += f"; mean gradient distance from the one-process f32 step {d:.4f} (one-process bf16 {d_one:.4f}, <= 1.5x)"
        ok = loss_rel <= 1e-2 and d <= 1.5 * d_one and stat_err <= 2e-2
    else:
        if name == "f32":
            leaf = {k: v[DDP_CANCELLING_LEAF] for k, v in
                    (("ranks", got[0]), ("one process", ref["f32"][1]), ("float64", ref["f64"][1]))}
            f64 = {k: leaf_cosines({0: v}, {0: leaf["float64"]})[0] for k, v in leaf.items() if k != "float64"}
            line += (f"; {DDP_CANCELLING_LEAF} {[round(float(v), 9) for v in leaf['ranks']]} (ranks), "
                     f"{[round(float(v), 9) for v in leaf['one process']]} (one process), "
                     f"{[round(float(v), 9) for v in leaf['float64']]} (float64 step), cosine to float64 "
                     + ", ".join(f"{k} {c:.7f}" for k, c in f64.items()))
        ok = loss_rel <= 1e-5 and cos[worst] >= 0.9999 and cos[DDP_CANCELLING_LEAF] >= 0.999 and stat_err <= 1e-3
    log(line)
    return ok and m["acc"] == m1["acc"]


def phase_ddp(dev):
    """Data-parallel training on cnn_L3_melspec2 at full width: two ranks on
    this card over gloo (and one rank per card over NCCL with two or more
    cards), each through tools/dp_check under torch.distributed.run. The f32
    sync step at a global batch of 8 against one process on the whole batch
    (loss within 1e-5, the same accuracy, every gradient leaf at cosine >=
    0.9999 but the BN-fed conv biases and DDP_CANCELLING_LEAF, held to
    0.999 and logged against a float64 step, BN batch statistics within
    1e-3), the
    bf16 step at phase_train's bf16 card gates, per_replica's running statistics
    against the mean of one-process steps on each rank's rows, the ranks'
    states equal, run_epochs in one run dir written by the chief alone with
    equal histories, and a stop raised on rank 1 alone taken by every rank
    at one step. With two or more cards: ms a step at 64 rows a card on
    1…N cards and the scaling efficiency."""
    import tempfile

    from l3embedding_torch.compat.from_jax import bn_fed_biases
    from l3embedding_torch.models.registry import build_model
    from l3embedding_torch.training.state import create_train_state
    from l3embedding_torch.training.steps import make_train_step

    n_cards = torch.cuda.device_count()
    noise = bn_fed_biases(TRAIN_MODEL)
    batches = avc_batches(7, DDP_BATCH, seed=31)
    stacked = {k: np.stack([b[k] for b in batches]) for k in ("video", "audio", "label")}
    ref = {"f32": one_train_step(torch.float32, dev, batches[0]),
           "bf16": one_train_step(torch.bfloat16, dev, batches[0]),
           "f64": one_train_step(torch.float64, dev, batches[0])}

    def per_replica_want(nproc):
        """The mean of the running statistics of nproc one-process steps,
        one on each rank's rows."""
        rows = DDP_BATCH // nproc
        parts = [one_train_step(torch.float32, dev, {k: v[i * rows:(i + 1) * rows] for k, v in batches[0].items()})[2]
                 for i in range(nproc)]
        return {n: sum(p[n] for p in parts) / nproc for n in parts[0]}
    d_one = np.mean([1 - c for c in leaf_cosines(ref["bf16"][1], ref["f32"][1], skip=noise).values()])
    tmp = tempfile.TemporaryDirectory()
    try:
        for backend, nproc, cards in [("gloo", 2, 1)] + ([("nccl", n_cards, n_cards)] if n_cards >= 2 else []):
            work = os.path.join(tmp.name, f"{backend}{nproc}")
            os.makedirs(work)
            np.savez(os.path.join(work, "batches.npz"), **stacked)
            wall = run_ranks(nproc, ["check", work], timeout=600, cards=cards)
            recs = []
            for r in range(nproc):
                with open(os.path.join(work, f"rank{r}.json")) as f:
                    recs.append(json.load(f))
            z = np.load(os.path.join(work, "rank0_steps.npz"))
            what = f"ddp {backend} {nproc} ranks on {cards} card(s)"
            if {r["backend"] for r in recs} != {backend} or len({r["device"] for r in recs}) != min(nproc, cards):
                raise SystemExit(f"{what}: ranks ran on {[(r['backend'], r['device']) for r in recs]}")
            got = {name: ({n: torch.from_numpy(z[f"{name}/grad/{n}"]).double() for n in ref["f32"][1]},
                          {n: torch.from_numpy(z[f"{name}/stat/{n}"]) for n in ref["f32"][2]})
                   for name in ("f32", "bf16", "per_replica")}
            failures = []
            for name in ("f32", "bf16"):
                if not parallel_step_gates(what, name, recs[0][f"{name}_metrics"], got[name], ref, noise, d_one):
                    failures.append(f"{name} step")
            pr_err = batch_stat_err(got["per_replica"][1], per_replica_want(nproc))
            log(f"{what}: per_replica running statistics vs the mean of {nproc} one-process steps on the ranks' "
                f"rows: batch statistics max relative error {pr_err:.2e} (<= 1e-3)")
            if pr_err > 1e-3:
                failures.append("per_replica statistics")
            for key in ("f32_checksum", "bf16_checksum", "per_replica_checksum", "run_checksum",
                        "model_dir", "history", "preempt_step"):
                if len({json.dumps(r[key]) for r in recs}) != 1:
                    failures.append(f"ranks differ in {key}")
            run_dir = recs[0]["model_dir"]
            files = set(os.listdir(run_dir))
            expected = {"model_latest.ckpt", "model_best_valid_accuracy.ckpt", "model_best_valid_loss.ckpt",
                        "model_checkpoint.00.ckpt", "history_csvlog.csv", "history_checkpoint.pkl", "history.pkl"}
            others = [w for r in recs[1:] for w in r["writes"]]
            log(f"{what}: run_epochs (4 steps, 2 evaluations): one run dir {run_dir} holding {sorted(files)}, "
                f"rank 0 opened {len(recs[0]['writes'])} files for writing, the other ranks {len(others)}; "
                f"history {recs[0]['history']}")
            if (files != expected or others or not recs[0]["writes"]
                    or len(os.listdir(os.path.dirname(run_dir))) != 1
                    or not np.isfinite([v[0] for v in recs[0]["history"].values()]).all()):
                failures.append("run_epochs")
            stops = [(r["preempt_stopped"], r["preempt_step"]) for r in recs]
            log(f"{what}: stop raised on rank 1 alone after 2 steps: (stopped, step) by rank {stops}")
            if not all(stopped for stopped, _ in stops) or len({s for _, s in stops}) != 1:
                failures.append("preemption")
            for r in recs:
                MAIN_PATH_LAUNCHES.update(r["launches"])
                if r["launches"].get("mel_frontend_f32", 0) < 1 or r["launches"].get("mel_frontend_bf16", 0) < 1:
                    failures.append(f"rank {r['rank']} launches {r['launches']}")
            ms = statistics.median(recs[0]["step_ms"])
            log(f"{what}: f32 sync step at global batch {DDP_BATCH} ({DDP_BATCH // nproc} a rank): median "
                f"{ms:.3f} ms (min {min(recs[0]['step_ms']):.3f}, 10 steps after 2); launches by rank "
                f"{[r['launches'] for r in recs]}; the whole launch {wall:.1f} s")
            if failures:
                raise SystemExit(f"{what}: {failures}")
        state = create_train_state(build_model(TRAIN_MODEL), torch.Generator().manual_seed(5), 1e-4,
                                   torch.float32, dev)
        step = make_train_step()
        big = {k: torch.from_numpy(v).to(dev) for k, v in batches[0].items()}
        times = []
        for i in range(12):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = step(state, big)
            torch.cuda.synchronize()
            if i >= 2:
                times.append((time.perf_counter() - t0) * 1e3)
        log(f"ddp: the one-process f32 step at batch {DDP_BATCH} on this card for comparison: median "
            f"{statistics.median(times):.3f} ms")
        del state
        if n_cards >= 2:
            work = os.path.join(tmp.name, "time")
            os.makedirs(work)
            results = {}
            for k in range(1, n_cards + 1):
                run_ranks(k, ["time", work, "--batch-per-rank", str(DDP_TIMING_BATCH)], timeout=600, cards=k)
                with open(os.path.join(work, f"time_{k}_m1.json")) as f:
                    results[k] = json.load(f)
            # One card runs the one-device step (no group); from two cards on
            # the step is the data-parallel one, whose BN works from sums.
            for name in ("f32", "bf16"):
                t1, t2 = results[1][name]["median_ms"], results[2][name]["median_ms"]
                for k, r in results.items():
                    ms = r[name]["median_ms"]
                    log(f"ddp scaling {name}: {k} card(s) ({r['backend']}), {DDP_TIMING_BATCH} rows a card: "
                        f"median {ms:.3f} ms a step (min {r[name]['min_ms']:.3f}, max {r[name]['max_ms']:.3f}), "
                        f"{k * DDP_TIMING_BATCH * 1e3 / ms:.1f} pairs/s, efficiency {t1 / ms:.3f} against one "
                        f"card's one-device step, {t2 / ms:.3f} against 2 cards")
        log("ddp timing on: " + subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().replace("\n", " | "))
    finally:
        tmp.cleanup()


TP_MODEL_AXIS = 2
TP_EMBED_WINDOWS = 8  # audio windows embedded from the TP and the one-process checkpoints


def smi_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().replace("\n", " | ")


def phase_tp(dev):
    """Tensor parallelism (parallel/tp.py) on cnn_L3_melspec2 at full width:
    tools/dp_check's ``tp`` mode under torch.distributed.run, the state split
    over a model axis of 2 by tp_shard_state: two ranks on this card over
    gloo (data 1 × model 2), and one rank per card over NCCL on 2 cards
    (data 1 × model 2) and on 4 (data 2 × model 2) where there are as many.
    The f32, bf16 and accum_steps=2 steps at a global batch of 8 against one
    process on the whole batch at phase_ddp's gates (parallel_step_gates);
    each rank's split slices equal to its slices of the gathered state the
    ranks wrote, the replicated leaves equal on every rank; that .ckpt
    into EmbeddingExtractor against the one-process step's .ckpt (cosine
    >= 0.9999); every rank through the mel kernel in f32 and bf16. Logged:
    parameter and Adam bytes a rank against pure data parallelism, and the
    ms a step at 64 rows a data replica, TP beside pure data parallelism on
    the same ranks and cards, with the card's name and power limit."""
    import hashlib
    import tempfile

    from l3embedding_torch.compat.from_jax import avc_from_jax_variables, bn_fed_biases
    from l3embedding_torch.embed.extract import EmbeddingExtractor
    from l3embedding_torch.parallel.tp import split_leaves
    from l3embedding_torch.training import checkpoints

    n_cards = torch.cuda.device_count()
    noise = bn_fed_biases(TRAIN_MODEL)
    split = split_leaves(TRAIN_MODEL)
    batch = avc_batches(1, DDP_BATCH, seed=31)[0]
    tmp = tempfile.TemporaryDirectory()
    try:
        one_ckpt = os.path.join(tmp.name, "one_f32.ckpt")
        ref = {"f32": one_train_step(torch.float32, dev, batch, save_to=one_ckpt),
               "bf16": one_train_step(torch.bfloat16, dev, batch),
               "accum2": one_train_step(torch.float32, dev, batch, accum_steps=2),
               "f64": one_train_step(torch.float64, dev, batch)}
        d_one = np.mean([1 - c for c in leaf_cosines(ref["bf16"][1], ref["f32"][1], skip=noise).values()])
        windows = audio_windows(TP_EMBED_WINDOWS, seed=41)
        one_emb = EmbeddingExtractor(one_ckpt, TRAIN_MODEL, "short", device=dev).embed_windows(windows)
        torch.cuda.empty_cache()
        layouts = [("gloo", 2, 1)] + [("nccl", k, k) for k in (2, 4) if k <= n_cards]
        for backend, nproc, cards in layouts:
            work = os.path.join(tmp.name, f"{backend}{nproc}")
            os.makedirs(work)
            np.savez(os.path.join(work, "batches.npz"), **{k: v[None] for k, v in batch.items()})
            wall = run_ranks(nproc, ["tp", work, "--model-axis", str(TP_MODEL_AXIS)], timeout=300, cards=cards)
            recs = []
            for r in range(nproc):
                with open(os.path.join(work, f"tp_rank{r}.json")) as f:
                    recs.append(json.load(f))
            data = nproc // TP_MODEL_AXIS
            what = f"tp {backend} {nproc} ranks (data {data} x model {TP_MODEL_AXIS}) on {cards} card(s)"
            if {r["backend"] for r in recs} != {backend} or len({r["device"] for r in recs}) != min(nproc, cards):
                raise SystemExit(f"{what}: ranks ran on {[(r['backend'], r['device']) for r in recs]}")
            z = np.load(os.path.join(work, "tp_steps.npz"))
            failures = []
            for name in ("f32", "bf16", "accum2"):
                got = ({n: torch.from_numpy(z[f"{name}/grad/{n}"]).double() for n in ref["f32"][1]},
                       {n: torch.from_numpy(z[f"{name}/stat/{n}"]) for n in ref["f32"][2]})
                if not parallel_step_gates(what, name, recs[0][f"{name}_metrics"], got, ref, noise, d_one):
                    failures.append(f"{name} step")
                if len({r[f"{name}_digests"]["replicated"] for r in recs}) != 1:
                    failures.append(f"{name}: replicated leaves differ between ranks")
            # Each rank's slices after the f32 step against the state the ranks gathered and wrote.
            tp_ckpt = os.path.join(work, "tp_f32.ckpt")
            sd = avc_from_jax_variables(checkpoints.read_tree(tp_ckpt), TRAIN_MODEL)
            for r in recs:
                m = r["mesh"][3]
                for n, dim in split.items():
                    k = sd[n].shape[dim] // TP_MODEL_AXIS
                    want = hashlib.sha256(sd[n].narrow(dim, m * k, k).contiguous().numpy().tobytes()).hexdigest()
                    if r["f32_digests"][n] != want:
                        failures.append(f"rank {r['rank']}: {n} is not its slice of the gathered state")
            emb = EmbeddingExtractor(tp_ckpt, TRAIN_MODEL, "short", device=dev).embed_windows(windows)
            emb_cos = row_cosines(torch.from_numpy(emb), torch.from_numpy(one_emb)).min().item()
            if emb.shape != one_emb.shape or not np.isfinite(emb).all() or emb_cos < 0.9999:
                failures.append(f"EmbeddingExtractor on the TP checkpoint: cosine {emb_cos}")
            if len({json.dumps(r["eval"]) for r in recs}) != 1:
                failures.append("ranks differ in the eval step's metrics")
            for r in recs:
                MAIN_PATH_LAUNCHES.update(r["launches"])
                if r["launches"].get("mel_frontend_f32", 0) < 1 or r["launches"].get("mel_frontend_bf16", 0) < 1:
                    failures.append(f"rank {r['rank']} launches {r['launches']}")
            log(f"{what}: slices of {len(split)} split leaves on each rank equal to the gathered state's "
                f"({'no' if not any('slice' in f for f in failures) else 'a'} mismatch), replicated leaves equal "
                f"on every rank; tp_f32.ckpt ({os.path.getsize(tp_ckpt) / 1e6:.1f} MB) → EmbeddingExtractor, "
                f"{TP_EMBED_WINDOWS} windows: min cosine {emb_cos:.7f} to the one-process checkpoint's "
                f"(>= 0.9999); eval {recs[0]['eval']}; launches by rank {[r['launches'] for r in recs]}; "
                f"the whole launch {wall:.1f} s")
            dp_params = sum(t.numel() for t in ref["f32"][1].values())
            log(f"{what}: parameter bytes a rank {[r['param_bytes'] for r in recs]}, Adam bytes a rank "
                f"{[r['adam_bytes'] for r in recs]}; pure data parallelism holds {4 * dp_params} and "
                f"{8 * dp_params + 4 * len(ref['f32'][1])} ({recs[0]['param_bytes'] / (4 * dp_params):.4f}x "
                f"of the parameters)")
            if failures:
                raise SystemExit(f"{what}: {failures}")
            # ms a step at 64 rows a data replica: TP, then pure data parallelism on the same ranks.
            times = {}
            for m in (TP_MODEL_AXIS, 1):
                run_ranks(nproc, ["time", work, "--model-axis", str(m), "--batch-per-rank", str(DDP_TIMING_BATCH),
                                  "--reps", "5"], timeout=300, cards=cards)
                with open(os.path.join(work, f"time_{nproc}_m{m}.json")) as f:
                    times[m] = json.load(f)
            for name in ("f32", "bf16"):
                tp_r, dp_r = times[TP_MODEL_AXIS][name], times[1][name]
                log(f"{what}: {name} step, {DDP_TIMING_BATCH} rows a data replica ({DDP_TIMING_BATCH * data} a "
                    f"step under TP, {DDP_TIMING_BATCH * nproc} under pure data parallelism on the same "
                    f"{nproc} ranks): TP median {tp_r['median_ms']:.3f} ms (min {tp_r['min_ms']:.3f}, max "
                    f"{tp_r['max_ms']:.3f}; {DDP_TIMING_BATCH * data * 1e3 / tp_r['median_ms']:.1f} pairs/s), "
                    f"pure data parallelism median {dp_r['median_ms']:.3f} ms (min {dp_r['min_ms']:.3f}, max "
                    f"{dp_r['max_ms']:.3f}; {DDP_TIMING_BATCH * nproc * 1e3 / dp_r['median_ms']:.1f} pairs/s); "
                    f"parameter bytes a rank {tp_r['param_bytes']} / {dp_r['param_bytes']}; 5 steps after 2; on "
                    + smi_line())
    finally:
        tmp.cleanup()


def phase_vggish(dev):
    """The VGGish baseline from a seeded npz (and seeded PCA parameters):
    72,141,184 parameters; 64 examples on the card against a CPU copy
    (cosine >= 0.9999 with TF32 off; postprocessed uint8 rows within one
    level); examples/s; then the 05 CLI with --features vggish on the
    40-WAV dcase2013 corpus, twice, files/s, every file's rows against the
    in-process extractor."""
    import tempfile

    from l3embedding_torch.cli import generate_embedding_samples as cli
    from l3embedding_torch.data.vggish_mel import waveform_to_examples
    from l3embedding_torch.models import vggish
    from l3embedding_torch.models.towers import ieee_fp32

    tmp = tempfile.TemporaryDirectory()
    try:
        model = vggish.VGGish()
        n_params = sum(p.numel() for p in model.parameters())
        model.reset_parameters(torch.Generator().manual_seed(3))
        res = os.path.join(tmp.name, "resources")
        os.makedirs(res)
        vggish.save_vggish_npz(os.path.join(res, "vggish_model.npz"), model)
        rng = np.random.RandomState(33)
        q, _ = np.linalg.qr(rng.randn(128, 128))
        np.savez(os.path.join(res, "vggish_pca_params.npz"), pca_eigen_vectors=q * 40.0,
                 pca_means=np.zeros(128))
        audio = audio_windows(1, seed=34, seconds=62.0)[0]
        examples = waveform_to_examples(audio, 48000)[:64]
        card = vggish.VGGishExtractor(res, device=dev)
        cpu = vggish.VGGishExtractor(res, device="cpu")
        rows, want = card.embed_examples(examples, postprocess=False), cpu.embed_examples(examples, postprocess=False)
        zero = (np.abs(rows).max(1) == 0) & (np.abs(want).max(1) == 0)
        cos = row_cosines(torch.from_numpy(rows[~zero]), torch.from_numpy(want[~zero])).min().item()
        post = np.abs(card.embed_examples(examples) - cpu.embed_examples(examples)).max()
        x = torch.from_numpy(np.ascontiguousarray(examples, np.float32)).to(dev)
        with torch.no_grad(), ieee_fp32(True):
            fwd_ms = cuda_ms(lambda: card.model(x))
        reps = 5
        card.embed_examples(examples, postprocess=False)
        t0 = time.perf_counter()
        for _ in range(reps):
            card.embed_examples(examples, postprocess=False)
        host_ms_ = (time.perf_counter() - t0) * 1e3 / reps
        log(f"vggish: {n_params} parameters; {examples.shape[0]} examples on the card vs a CPU copy: min cosine "
            f"{cos:.7f} (>= 0.9999, {int(zero.sum())} rows zero on both), postprocessed max difference "
            f"{post:.0f} level(s) (<= 1); f32 forward {fwd_ms:.3f} ms ({examples.shape[0] * 1e3 / fwd_ms:.1f} "
            f"examples/s, CUDA events), embed_examples {host_ms_:.3f} ms ({examples.shape[0] * 1e3 / host_ms_:.1f} "
            f"examples/s, host clock with upload and download)")
        if n_params != 72_141_184 or cos < 0.9999 or post > 1 or zero.all():
            raise SystemExit("vggish: the card disagrees with the CPU copy or the model has the wrong size")
        _, data = corpus_fixture(os.path.join(tmp.name, "corpus"))
        for round_ in (1, 2):
            out = os.path.join(tmp.name, f"out{round_}")
            t0 = time.perf_counter()
            rc = cli.main(["--features", "vggish", "--vggish-resources-dir", res, "-hs", "0.1", "--device", dev,
                           "dcase2013", data, out])
            wall = time.perf_counter() - t0
            top = os.path.join(out, "features", "dcase2013", "vggish")
            tree = {}
            for fold in sorted(os.listdir(top)):
                if fold.startswith("fold"):
                    for f in sorted(os.listdir(os.path.join(top, fold))):
                        with np.load(os.path.join(top, fold, f)) as z:
                            tree[f"{fold}/{f}"] = z["X"]
            examples_n = sum(x.shape[0] for x in tree.values())
            log(f"vggish 05 --features vggish (round {round_}): rc {rc}, {len(tree)} files, {examples_n} examples "
                f"in {wall:.2f} s (the whole CLI): {len(tree) / wall:.2f} files/s, {examples_n / wall:.1f} examples/s")
            if rc != 0 or len(tree) != 40:
                raise SystemExit(f"vggish 05: rc {rc}, {len(tree)} files")
        worst = max(np.abs(x - card.embed_file(os.path.join(data, k.replace(".npz", ".wav")), hop_size=0.1)).max()
                    for k, x in tree.items())
        log(f"vggish 05: every file's rows against the in-process extractor: max difference {worst:.0f} level(s)")
        if worst > 1 or not all(x.shape[1] == 128 and np.isfinite(x).all() for x in tree.values()):
            raise SystemExit("vggish 05: rows disagree with the in-process extractor")
        log("vggish timing on: " + subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip())
    finally:
        tmp.cleanup()


# UrbanSound8K at hop 0.1 s: 8,732 clips of up to 4 s in 10 folds, 31
# 'original' rows (6144-d) a clip, 10 classes (phase_classify).
CLS_FOLDS, CLS_FILES, CLS_FRAMES, CLS_DIM, CLS_CLASSES = 10, 873, 31, 6144, 10
CLS_BATCH = 64  # 06's default train batch
CLS_CARD_CPU_ROWS = 4096


def us8k_split(dev, seed: int) -> tuple[dict, dict, dict]:
    """Seeded class-structured 'original' features at UrbanSound8K's scale,
    as get_split and the framewise preprocessing leave them: fold 1 the
    test fold (labels and file_idxs per file), fold 10 the valid fold and
    folds 2-9 the training set (labels per row). A file's rows are its
    class mean (0.03 · N(0, 1) per dimension) plus N(0, 1) noise; made on the
    card fold by fold, copied into host arrays (6.6 GB in all)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    means = 0.03 * torch.randn((CLS_CLASSES, CLS_DIM), generator=g, device=dev)
    rows = CLS_FILES * CLS_FRAMES
    y = np.arange(CLS_FILES) % CLS_CLASSES
    y_dev = torch.from_numpy(y).to(dev)
    spans = np.stack([np.arange(CLS_FILES) * CLS_FRAMES, np.arange(1, CLS_FILES + 1) * CLS_FRAMES], 1)

    def fold_into(dst: np.ndarray) -> None:
        x = torch.randn((CLS_FILES, CLS_FRAMES, CLS_DIM), generator=g, device=dev)
        x += means[y_dev][:, None, :]
        torch.from_numpy(dst).copy_(x.view(rows, CLS_DIM))

    test = {"features": np.empty((rows, CLS_DIM), np.float32), "labels": y, "file_idxs": spans}
    valid = {"features": np.empty((rows, CLS_DIM), np.float32), "labels": np.repeat(y, CLS_FRAMES),
             "file_idxs": spans}
    n_train = CLS_FOLDS - 2
    train = {"features": np.empty((n_train * rows, CLS_DIM), np.float32),
             "labels": np.tile(np.repeat(y, CLS_FRAMES), n_train),
             "file_idxs": np.concatenate([spans + i * rows for i in range(n_train)])}
    fold_into(test["features"])
    for i in range(n_train):
        fold_into(train["features"][i * rows:(i + 1) * rows])
    fold_into(valid["features"])
    return train, valid, test


def epoch_device_share(prof) -> tuple[float, int, list]:
    """(device busy ms, event count, top 5 (name, ms)) of the device events that start
    after the first step's minibatch gather was issued (the first
    ``aten::index_select`` on the host), that is of the epoch: the uploads of
    the training set, the valid set and the model come before it."""
    start = min(e.time_range.start for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CPU and e.name == "aten::index_select")
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False) and e.time_range.start >= start]
    busy_us, end, by_name = 0.0, float("-inf"), defaultdict(float)
    for e in sorted(events, key=lambda e: e.time_range.start):
        if e.time_range.end > end:
            busy_us += e.time_range.end - max(e.time_range.start, end)
            end = e.time_range.end
        by_name[e.name] += e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:5]
    return busy_us / 1e3, len(events), [(name, us / 1e3) for name, us in top]


def standardize(train: dict, test: dict) -> None:
    """StandardScaler's arithmetic in numpy (fit on train; a zero variance
    scales by 1), for machines without sklearn."""
    mean = train["features"].mean(0)
    std = train["features"].std(0)
    std[std == 0] = 1.0
    for data in (train, test):
        data["features"] = ((data["features"] - mean) / std).astype(np.float32)


def phase_classify(dev, corpus_split):
    """The downstream classifier (06's MLP) on the card.
    - US8K scale (us8k_split): classifier/train.py::train_mlp, 3 epochs at
      batch 64, lr 1e-4: s/epoch, steps/s, training rows/s, peak memory, the
      file-level test accuracy (>= 0.5); the device's idle share over one
      epoch at 1/10 of the rows (torch.profiler).
    - Card against CPU: train_mlp_torch from the same initial parameters, 2
      epochs on 4096 rows: per-layer cosine >= 0.9999, the epochs' losses
      within CLS_LOSS_REL, predict_proba rows at cosine >= 0.9999.
    - 05 to 06: phase_corpus's f32 dcase2013 features, standardised, fold 2
      trains (06's defaults, 150 epochs, patience 20), fold 1 tests: the
      file-level accuracy (>= 0.5; 10 classes).
    - train() and the 06 CLI where sklearn is installed (a small feature
      directory), else a line that says they were left out."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from l3embedding_torch.classifier import mlp
    from l3embedding_torch.classifier import train as cls_train
    from l3embedding_torch.compat.to_jax import mlp_to_jax
    from l3embedding_torch.data.usc.features import expand_framewise_labels

    tmp = tempfile.TemporaryDirectory()
    try:
        t0 = time.perf_counter()
        train, valid, test = us8k_split(dev, seed=61)
        log(f"classify: US8K-scale features made in {time.perf_counter() - t0:.1f} s: train "
            f"{train['features'].shape}, valid {valid['features'].shape}, test {test['features'].shape} "
            f"({len(test['labels'])} files), f32")
        histories = []
        real = cls_train.train_mlp_torch

        def recording(*args, **kwargs):
            model, hist = real(*args, **kwargs)
            histories.append(hist)
            return model, hist

        cls_train.train_mlp_torch = recording
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            _, _, va_m, te_m = cls_train.train_mlp(train, valid, test, tmp.name, batch_size=CLS_BATCH, num_epochs=3,
                                                   learning_rate=1e-4, num_classes=CLS_CLASSES,
                                                   random_state=20171021, device=dev)
        finally:
            cls_train.train_mlp_torch = real
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        (hist,) = histories
        steps = len(train["labels"]) // CLS_BATCH
        for e, sec in enumerate(hist["epoch_seconds"]):
            log(f"classify mlp epoch {e}: {sec:.3f} s, {steps} steps ({steps / sec:.1f} steps/s, "
                f"{steps * CLS_BATCH / sec:.0f} training rows/s), loss {hist['train_loss'][e]:.4f} acc "
                f"{hist['train_acc'][e]:.4f}, val_loss {hist['valid_loss'][e]:.4f} val_acc {hist['valid_acc'][e]:.4f}")
        log(f"classify mlp: train_mlp {wall:.2f} s in all (uploads, 3 epochs, predict_proba over train, valid "
            f"and test, host clock); peak memory {peak:.2f} GiB; file-level test accuracy {te_m['accuracy']:.4f}, "
            f"frame-level valid accuracy {va_m['accuracy']:.4f} (10 classes)")
        if not (te_m["accuracy"] >= 0.5 and np.isfinite(hist["train_loss"]).all()):
            raise SystemExit("classify: the MLP did not learn the US8K-scale task")

        n = len(train["labels"]) // 10
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
            _, h = mlp.train_mlp_torch(train["features"][:n], train["labels"][:n], valid["features"][:n // 8],
                                       valid["labels"][:n // 8], num_epochs=1, batch_size=CLS_BATCH,
                                       random_state=5, device=dev)
        epoch_ms = h["epoch_seconds"][0] * 1e3
        busy, count, top = epoch_device_share(prof)
        log(f"profile classify mlp: one epoch of {n // CLS_BATCH} steps at 1/10 of the rows: wall {epoch_ms:.1f} ms "
            f"(host clock; {epoch_ms / (n // CLS_BATCH):.3f} ms a step), device busy {busy:.1f} ms (union of {count} "
            f"device events), idle share {1 - busy / epoch_ms:.3f}")
        for name, ms in top:
            log(f"  {ms:8.3f} ms  {name[:90]}")

        X, y = train["features"][:CLS_CARD_CPU_ROWS], train["labels"][:CLS_CARD_CPU_ROWS]
        Xv, yv = valid["features"][:1024], valid["labels"][:1024]
        runs = {}
        for device in (dev, "cpu"):
            model, h = mlp.train_mlp_torch(X, y, Xv, yv, num_epochs=2, batch_size=CLS_BATCH, random_state=7,
                                           device=device)
            runs[device] = (mlp_to_jax(model), h, mlp.predict_proba(model, test["features"][:4096]))
        cos = min(row_cosines(torch.from_numpy(a[k]).reshape(1, -1), torch.from_numpy(b[k]).reshape(1, -1)).item()
                  for a, b in zip(runs[dev][0], runs["cpu"][0]) for k in ("w", "b"))
        rel = max(abs(a / b - 1) for key in ("train_loss", "valid_loss")
                  for a, b in zip(runs[dev][1][key], runs["cpu"][1][key]))
        prob = row_cosines(torch.from_numpy(runs[dev][2]), torch.from_numpy(runs["cpu"][2])).min().item()
        log(f"classify mlp card vs CPU (2 epochs, {CLS_CARD_CPU_ROWS} rows, same initial parameters): min layer "
            f"cosine {cos:.8f} (>= 0.9999), epoch losses within {rel:.2e} relative (<= {CLS_LOSS_REL}), "
            f"predict_proba rows min cosine {prob:.8f} (>= 0.9999)")
        if cos < 0.9999 or rel > CLS_LOSS_REL or prob < 0.9999:
            raise SystemExit("classify: the MLP on the card disagrees with the CPU")

        ctrain, ctest = corpus_split
        expand_framewise_labels(ctrain)
        standardize(ctrain, ctest)
        chain_dir = os.path.join(tmp.name, "chain")
        os.makedirs(chain_dir)
        t0 = time.perf_counter()
        _, _, _, chain_m = cls_train.train_mlp(ctrain, None, ctest, chain_dir, num_epochs=150, patience=20,
                                               num_classes=10, random_state=20171021, device=dev)
        log(f"classify 05 -> 06 (dcase2013 tone corpus, cnn_L3_melspec2 f32 'original' rows from phase_corpus): "
            f"train fold 2 {ctrain['features'].shape}, test fold 1 {len(ctest['labels'])} files; train_mlp "
            f"{time.perf_counter() - t0:.2f} s; file-level test accuracy {chain_m['accuracy']:.4f}")
        if not chain_m["accuracy"] >= 0.5:
            raise SystemExit("classify 05 -> 06: the MLP did not learn the tone classes")

        try:
            import sklearn  # noqa: F401
        except ImportError:
            log("classify: sklearn is not installed here: train() and the 06 CLI (their scalers need it) "
                "run in the CPU suite only")
        else:
            classify_with_sklearn(dev, tmp.name)
    finally:
        tmp.cleanup()


# The card's and the CPU's epoch losses from the same start: 9.7e-8
# relative on an NVIDIA H100 80GB HBM3, 700 W (PERF.md §6, PR 12).
CLS_LOSS_REL = 1e-5


def classify_with_sklearn(dev, root: str) -> None:
    """train() and the 06 CLI (mlp on the card) on a small us8k feature
    directory; results.pkl holds train, valid and test."""
    import pickle

    from l3embedding_torch.classifier import train as cls_train
    from l3embedding_torch.cli import train_classifier

    feats = os.path.join(root, "features", "us8k", "l3", "original", "music", "cnn_L3_melspec2")
    rng = np.random.RandomState(62)
    for fold in range(1, 11):
        os.makedirs(os.path.join(feats, f"fold{fold}"))
        for i in range(10):
            x = (rng.randn(8, 64) + 3.0 * i).astype(np.float32)
            np.savez_compressed(os.path.join(feats, f"fold{fold}", f"file{fold}-{i}-0-{i}.npz"), X=x, y=i)
    model_dir, results = cls_train.train(feats, os.path.join(root, "cls"), 1, model_type="mlp", num_epochs=5,
                                         device=dev)
    rc = train_classifier.main(["-mt", "mlp", "-e", "5", "--device", dev, feats, os.path.join(root, "cli"), "2"])
    runs = [os.path.join(d, "results.pkl") for d, _, files in os.walk(os.path.join(root, "cli"))
            if "results.pkl" in files]
    with open(runs[0], "rb") as f:
        keys = sorted(pickle.load(f))
    log(f"classify train() mlp: test accuracy {results['test']['accuracy']:.4f}; 06 CLI rc {rc}, results.pkl keys "
        f"{keys}")
    if rc != 0 or keys != ["test", "train", "valid"] or sorted(results) != keys:
        raise SystemExit("classify: train() or the 06 CLI failed")


def build_kernels():
    """Build every kernel source at once (one nvcc each), then load them."""
    from l3embedding_torch.ops import block1_kernel, cuda_build, int8_conv_kernel, mel_kernel, spec_kernel

    from l3embedding_torch import native

    t0 = time.perf_counter()
    names = ("mel_frontend", "spec_frontend", "block1_conv", "int8_conv")
    with ThreadPoolExecutor(len(names) + 1) as pool:
        host = pool.submit(native.build)
        for name, lib in zip(names, pool.map(lambda n: cuda_build.build(n, verbose=True), names)):
            log(f"built {name}: {lib.name}")
        host = host.result()
    if host is None or not native.available():
        raise SystemExit("build: the native host library (native/l3host.cpp) did not build or load")
    log(f"built the native host library: {host.relative_to(REPO)}")
    mel_kernel._library()
    spec_kernel._library()
    block1_kernel._library()
    int8_conv_kernel._library()
    log(f"build: {time.perf_counter() - t0:.1f} s")


# name → (source, the JAX package's kernel it replaces, operand types). The
# int8 conv replaces an XLA conv (s8 × s8 → s32), not a Pallas kernel.
KERNELS = {
    "mel_frontend": ("l3embedding_torch/csrc/mel_frontend.cu", "l3embedding_tpu/ops/pallas_frontend.py:81",
                     ("bf16", "f32")),
    "spec_frontend": ("l3embedding_torch/csrc/spec_frontend.cu", "l3embedding_tpu/ops/pallas_frontend.py:183",
                      ("bf16", "f32")),
    "block1_gemm": ("l3embedding_torch/csrc/block1_conv.cu", "tools/pallas_block1_spike.py:115", ("bf16",)),
    "block1_conv": ("l3embedding_torch/csrc/block1_conv.cu", "tools/pallas_block1_spike.py:150", ("bf16",)),
    "int8_conv": ("l3embedding_torch/csrc/int8_conv.cu", "l3embedding_tpu/embed/quantized.py:132", ("s8",)),
}


def by_mode(results: dict) -> dict:
    """A phase's results keyed by fast (True = bf16, False = f32) → by mode."""
    return {"bf16" if fast else "f32": v for fast, v in results.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = "cuda"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    build_kernels()
    measured = {"mel_frontend": phase_kernel(dev), "spec_frontend": phase_spec_kernel(dev),
                **phase_block1(dev)}
    measured = {name: by_mode(r) for name, r in measured.items()}
    measured["int8_conv"] = {"s8": phase_int8_kernel(dev)[True]}
    phase_slice(dev)
    phase_avc(dev)
    phase_image(dev)
    phase_files(dev)
    phase_serve(dev)
    phase_profile(dev)
    trained = phase_train(dev)
    phase_sample(dev, trained)
    del trained
    phase_int8(dev)
    corpus_split = phase_corpus(dev)
    phase_ddp(dev)
    phase_tp(dev)
    phase_vggish(dev)
    phase_classify(dev, corpus_split)

    kernels = []
    for name, (src, replaces, modes) in KERNELS.items():
        for mode in modes:
            key = f"{name}_{mode}"
            if MAIN_PATH_LAUNCHES[key] < 1:
                raise SystemExit(f"{key} was not launched on the main paths")
            kernels.append({"name": key, "route": "cuda", "source": src, "replaces": replaces,
                            "launches": MAIN_PATH_LAUNCHES[key], **measured[name][mode]})
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
