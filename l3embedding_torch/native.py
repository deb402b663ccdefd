"""ctypes binding of the repo's native host library (``native/l3host.cpp``),
after ``l3embedding_tpu/native/__init__.py``: the same five entry points and
``available()``, each with its numpy plain version.

The library is compiled from ``native/l3host.cpp`` at first use with the
JAX binding's flags (``-O3 -fPIC -shared -std=c++17``, so the numerics are
the same) into ``build/l3host/`` at the repo root, under a name that
carries a hash of the source and the flags, so a stale library is never
loaded. The library file tracked beside the source is neither written nor
loaded here. Without a C++ compiler every entry point runs its numpy plain
version, and the fallback is logged at WARNING; ``available()`` says which
path runs. These are the host-side hot ops of the sample factory and the
input pipeline.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from .ops import image as I

LOGGER = logging.getLogger("l3embedding_torch.native")

_REPO = Path(__file__).resolve().parents[1]
SOURCE = _REPO / "native" / "l3host.cpp"
BUILD_DIR = _REPO / "build" / "l3host"
CXXFLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_lib = None
_tried = False


def library_path() -> Path:
    """Where the library of this version of the source goes."""
    digest = hashlib.sha1(SOURCE.read_bytes())
    digest.update(" ".join(CXXFLAGS).encode())
    return BUILD_DIR / f"libl3host_{digest.hexdigest()[:12]}.so"


def build() -> Path | None:
    """Compile the source (once per version) → the library's path, or None
    when there is no compiler or the build fails. The library appears
    atomically, so processes that build at once never load a partial file."""
    lib = library_path()
    if lib.exists():
        return lib
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        LOGGER.warning("no C++ compiler (g++ / c++) to build %s", SOURCE)
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([cxx, *CXXFLAGS, "-o", tmp, str(SOURCE)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib)
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired) as e:
        LOGGER.warning("native build failed: %s %s", e, getattr(e, "stderr", b"")[-2000:])
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = build()
    if path is None:
        LOGGER.warning("the native host library is unavailable; using the numpy plain versions")
        return None
    try:
        lib = ctypes.CDLL(str(path))
        lib.l3host_abi_version.restype = ctypes.c_int
        if lib.l3host_abi_version() != 1:
            raise OSError("ABI version mismatch")
        lib.pcm16_to_float.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        lib.u8_to_pm1.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        lib.augment_frame_u8.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_int]
        lib.gain_i16.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_double]
        lib.resize_nn_u8.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
        _lib = lib
    except OSError as e:
        LOGGER.warning("could not load %s (%s); using the numpy plain versions", path, e)
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def pcm16_to_float(x: np.ndarray) -> np.ndarray:
    """int16 → float32 in [-1, 1)."""
    x = np.ascontiguousarray(x, dtype=np.int16)
    lib = _load()
    if lib is None:
        return x.astype(np.float32) / 32768.0
    out = np.empty(x.shape, np.float32)
    lib.pcm16_to_float(x.ctypes.data, out.ctypes.data, x.size)
    return out


def u8_to_pm1(x: np.ndarray) -> np.ndarray:
    """uint8 → float32 in [-1, 1]."""
    x = np.ascontiguousarray(x, dtype=np.uint8)
    lib = _load()
    if lib is None:
        return 2.0 * (x.astype(np.float32) / 255.0) - 1.0
    out = np.empty(x.shape, np.float32)
    lib.u8_to_pm1(x.ctypes.data, out.ctypes.data, x.size)
    return out


def augment_frame_plain(frame: np.ndarray, flip: bool, saturation_factor: float,
                        brightness_delta: float, sat_first: bool) -> np.ndarray:
    """The numpy chain horiz_flip → adjust_saturation ↔ adjust_brightness
    (order per sat_first) on float64 images (reference sample.py:236-276)."""
    f = I.img_as_float(np.ascontiguousarray(frame, dtype=np.uint8))
    if flip:
        f = I.horiz_flip(f)
    if sat_first:
        f = I.adjust_saturation(f, saturation_factor)
        f = I.adjust_brightness(f, brightness_delta)
    else:
        f = I.adjust_brightness(f, brightness_delta)
        f = I.adjust_saturation(f, saturation_factor)
    return I.img_as_ubyte(f)


def augment_frame(frame: np.ndarray, flip: bool, saturation_factor: float,
                  brightness_delta: float, sat_first: bool) -> np.ndarray:
    """Fused flip + saturation + brightness on a uint8 (H, W, 3) frame, in
    one pass; equal to ``augment_frame_plain`` up to 1 LSB of the uint8
    rounding."""
    frame = np.ascontiguousarray(frame, dtype=np.uint8)
    lib = _load()
    if lib is None:
        return augment_frame_plain(frame, flip, saturation_factor, brightness_delta, sat_first)
    h, w, _ = frame.shape
    out = np.empty_like(frame)
    lib.augment_frame_u8(frame.ctypes.data, out.ctypes.data, h, w, int(flip),
                         float(saturation_factor), float(brightness_delta), int(sat_first))
    return out


def gain_i16(x: np.ndarray, gain: float) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.int16)
    lib = _load()
    if lib is None:
        return np.clip(x.astype(np.float64) * gain, -32768, 32767).astype(np.int16)
    out = np.empty(x.shape, np.int16)
    lib.gain_i16(x.ctypes.data, out.ctypes.data, x.size, float(gain))
    return out


def resize_nn(frame: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    frame = np.ascontiguousarray(frame, dtype=np.uint8)
    in_h, in_w, _ = frame.shape
    lib = _load()
    if lib is None:
        yi = np.minimum(in_h - 1, np.arange(out_h) * in_h // out_h)
        xi = np.minimum(in_w - 1, np.arange(out_w) * in_w // out_w)
        return frame[yi][:, xi]
    out = np.empty((out_h, out_w, 3), np.uint8)
    lib.resize_nn_u8(frame.ctypes.data, in_h, in_w, out.ctypes.data, out_h, out_w)
    return out
