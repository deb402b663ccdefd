"""The benchmark's traffic: mixes of data, and the generator of each kind.

A traffic mix is a data file, ``l3bench/traffic/<mix>.json``, of
parameters; its ``kind`` names the generator that turns it and a seed into
the inputs of a run, ``l3bench/generators/<kind>.py``, found by that name.
A mix of a kind that exists is data alone; a new kind is a new generator
file beside the others.
"""

from __future__ import annotations

import importlib
import json
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
TRAFFIC_DIR = HERE / "traffic"
GENERATORS_DIR = HERE / "generators"


def load_mix(name: str) -> dict:
    with open(TRAFFIC_DIR / f"{name}.json") as f:
        mix = json.load(f)
    kind = str(mix.get("kind", ""))
    if not kind.isidentifier() or not (GENERATORS_DIR / f"{kind}.py").is_file():
        raise ValueError(f"traffic {name!r}: no generator for kind {kind!r} in {GENERATORS_DIR.name}/")
    return mix


def generator(mix: dict):
    """The module that generates a mix of this kind."""
    return importlib.import_module(f"l3bench.generators.{mix['kind']}")


def torch_generator(seed: int, device: str) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2**63))
    return g
