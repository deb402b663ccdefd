"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each source under ``l3embedding_torch/csrc/`` is compiled on its own for
``sm_90a`` into a shared library with a plain C interface, under
``build/l3torch_kernels/`` at the repo root. The library's name carries a
hash of the source and of every local header it includes (``#include
"..."``, followed recursively), so an edit to a shared header rebuilds
every source that uses it and a stale library is never loaded.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "l3torch_kernels"

_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")


def source_files(source: Path) -> list[Path]:
    """`source` and every local header it includes, transitively, in a
    fixed order."""
    seen: list[Path] = []
    stack = [source.resolve()]
    while stack:
        path = stack.pop()
        if path in seen:
            continue
        seen.append(path)
        for name in _LOCAL_INCLUDE.findall(path.read_bytes()):
            stack.append((path.parent / name.decode()).resolve())
    return seen


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` goes, named by the hash of
    its source and headers."""
    digest = hashlib.sha1()
    for path in source_files(CSRC / f"{name}.cu"):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:12]}.so"


def build(name: str, verbose: bool = False) -> Path:
    """Compile ``csrc/<name>.cu`` (once per version of its sources) and
    return the .so path. Raises with nvcc's output when it fails."""
    lib = library_path(name)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-o", tmp, str(CSRC / f"{name}.cu"),
    ]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {name}.cu ({proc.returncode}):\n{proc.stderr}")
    if verbose:
        print(proc.stderr, end="")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, loaded once per process."""
    return ctypes.CDLL(str(build(name)))


def on_device(device: torch.device):
    """Make `device` current around a launch; no guard when it already is
    (the launch goes to the runtime's current device)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)
