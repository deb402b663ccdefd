"""What a driver is given for one run, and the look for modules of JAX."""

from __future__ import annotations

import importlib
import sys
from dataclasses import dataclass

# Top-level module names that no process of a run may hold once its window
# has closed: JAX, its libraries, and the JAX package the program was ported
# from (whose name the program's own name begins with).
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "l3embedding_tpu")


@dataclass
class Context:
    cell: dict  # l3bench/cells/<cell>.json
    config: dict  # l3bench/configs/<config>.json
    mix: dict  # l3bench/traffic/<mix>.json
    seed: int
    seconds: float
    trace: bool
    device: str  # "cuda" on the card; "cpu" only in the tests
    t0: float  # time.time() when the run's first process started
    world: int = 1  # processes of the run: the cell's chips
    controls: tuple = ()  # what the calibration reads beside the program ("fp8", "tf32", "int8prog")
    plant: str | None = None  # "module:function" that breaks the program (the tests' faults)
    marks: tuple = ()  # (phase, seconds from t0) of set-up before the driver: the set-up's first phases


def resolve(plant: str | None):
    """The function that a Context's `plant` names, or None."""
    if not plant:
        return None
    module, name = plant.split(":")
    return getattr(importlib.import_module(module), name)


def loaded_forbidden() -> list[str]:
    """Modules of this process whose top-level name, compared whole, is
    one of FORBIDDEN."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
