"""Faults of the Whisper encoder cell, planted under the harness by the
tests and by the calibration (``Context.plant``): each breaks the timed
path as a wrong optimisation could, and the run must then come out not
correct."""

from __future__ import annotations

import torch


def skip_block(ext) -> None:
    """The middle block of the encoder is left out."""
    blocks = ext.model.encoder.blocks
    del blocks[len(blocks) // 2]


def shift_positions(ext) -> None:
    """The positional table is shifted by one frame: frame t gets position
    t − 1's row (frame 0 the last's)."""
    table = ext.model.encoder.positional_embedding
    with torch.no_grad():
        table.copy_(torch.roll(table, 1, 0))


def alter_window(ext) -> None:
    """One window of every call has its rows scaled by 1.5."""
    model = ext.models[0]
    forward = model.forward

    def altered(x):
        y = forward(x).clone()
        y[0] *= 1.5
        return y

    model.forward = altered


def nan_window(ext) -> None:
    """One window of every call has a row that is not a number."""
    model = ext.models[0]
    forward = model.forward

    def altered(x):
        y = forward(x).clone()
        y[0, 0] = float("nan")
        return y

    model.forward = altered
