"""Weights of a run, made from the seed on the device.

The leaves are the plain reference's (``reference.model.param_specs``):
one ``torch.randn`` over all of them with a generator on the device, then
each slice scaled to its kind. The same seed gives the same weights on the
same kind of device. The drivers copy them into the program, and the
reference takes its own copy, so neither side reads what the other made.
"""

from __future__ import annotations

import math

import torch

from .generate import torch_generator

# The output layer starts at a hundredth of He's scale, so that the logits
# start near 0 and the softmax is not saturated: a He-scaled head starts at
# logits of about +-5, where the loss of a step and each sample's weight in
# the gradient swing with the last bits of the logits.
OUT_SCALE = 0.01


def make(specs: list[tuple], seed: int, device: str) -> dict[str, torch.Tensor]:
    """{name: float32 tensor on `device`} for `specs` ((name, shape, kind,
    fan_in) rows): conv and dense kernels He-normal (the output layer's at
    OUT_SCALE of it), biases N(0, 0.01),
    BatchNorm scale 1 + 0.1·N, offset 0.1·N, running mean 0.1·N, running
    variance 1 + 0.1·|N|."""
    g = torch_generator(seed, device)
    sizes = [math.prod(shape) for _, shape, _, _ in specs]
    z = torch.randn(sum(sizes), generator=g, device=device)
    out, off = {}, 0
    for (name, shape, kind, fan_in), n in zip(specs, sizes):
        v = z[off:off + n].view(shape)
        off += n
        if kind == "kernel":
            v = v * math.sqrt(2.0 / fan_in)
        elif kind == "out_kernel":
            v = v * OUT_SCALE * math.sqrt(2.0 / fan_in)
        elif kind == "bias":
            v = v * 0.01
        elif kind == "scale":
            v = 1.0 + 0.1 * v
        elif kind in ("offset", "mean"):
            v = 0.1 * v
        elif kind == "var":
            v = 1.0 + 0.1 * v.abs()
        else:
            raise ValueError(f"unknown leaf kind {kind!r}")
        out[name] = v.contiguous()
    return out
