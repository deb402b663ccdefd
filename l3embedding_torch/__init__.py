"""PyTorch/CUDA port of l3embedding_tpu on an NVIDIA H100: L3 audio and
image embedding extraction (from arrays and files, with framing on the
device), exported artifacts, the serving stack (micro-batching service,
streaming, HTTP) and the AVC forward for all five model types, with the
audio front ends (mel and linear spectrogram) as hand-written Hopper
kernels.

Imports torch, numpy and scipy only; nothing of JAX or l3embedding_tpu.
"""
