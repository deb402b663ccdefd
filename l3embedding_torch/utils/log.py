"""Logging: timed blocks and console / rotating-file handlers (a jax-free
copy of ``l3embedding_tpu/utils/log.py``, reference log.py:6-137).
``StepTimer`` waits for the card before it takes the end time, so it
measures device time rather than the time to enqueue the work."""

from __future__ import annotations

import logging
import logging.handlers
import time

import torch


class LogTimer:
    """Context manager that logs the wall time of a block."""

    def __init__(self, logger, desc, level=logging.DEBUG):
        self.logger = logger
        self.desc = desc
        self.level = level

    def __enter__(self):
        self.start = time.time()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.elapsed = time.time() - self.start
        self.logger.log(self.level, "%s took %f seconds", self.desc, self.elapsed)
        return False


def _cuda_devices(out, found: set) -> set:
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            found.add(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _cuda_devices(v, found)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _cuda_devices(v, found)
    return found


class StepTimer:
    """Times a step under asynchronous CUDA launches.

    Usage:
        with StepTimer() as t:
            out = step(...)
            t.observe(out)   # waits for the devices that hold `out`
        t.elapsed
    """

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def observe(self, out):
        for device in _cuda_devices(out, set()):
            torch.cuda.synchronize(device)
        return out

    def __exit__(self, exc_type, exc, tb):
        self.elapsed = time.perf_counter() - self.start
        return False


def init_console_logger(logger, verbose=False):
    """Log to the console; a later call (a CLI run again in one process)
    replaces the handler an earlier call added instead of adding another."""
    for h in [h for h in logger.handlers if getattr(h, "l3_console", False)]:
        logger.removeHandler(h)
    ch = logging.StreamHandler()
    ch.l3_console = True
    ch.setLevel(logging.DEBUG if verbose else logging.INFO)
    ch.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s"))
    logger.addHandler(ch)


def init_file_logger(logger, log_path=None):
    if log_path is None:
        log_path = "./l3embedding_torch.log"
    fh = logging.handlers.RotatingFileHandler(log_path, maxBytes=1024 * 1024, backupCount=10)
    fh.setLevel(logging.DEBUG)
    fh.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s"))
    logger.addHandler(fh)
