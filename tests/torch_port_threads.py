"""Module fixtures for the port's test files: torch on one (or two)
threads while the module's tests run, the previous count restored after
them.

The suite runs six test files at once, one per worker process, on a
machine of a few cores. Torch's default of one thread per core in each of
them oversubscribes it, and its thread pools then spend most of their time
waiting for each other: beside five such processes a port test file runs
several times faster on one thread than on torch's default count. The
arithmetic of a step changes with the thread
count (the reductions split differently): the files that import
``one_torch_thread`` pass on one thread; ``tests/test_torch_port_train.py``
fails two melspec2 gates there and passes on two (``two_torch_threads``).

Use: ``from torch_port_threads import one_torch_thread  # noqa: F401``.
"""

import pytest
import torch


def _torch_threads(n: int, name: str):
    @pytest.fixture(autouse=True, scope="module", name=name)
    def fixture():
        before = torch.get_num_threads()
        torch.set_num_threads(n)
        yield
        torch.set_num_threads(before)

    return fixture


one_torch_thread = _torch_threads(1, "one_torch_thread")
two_torch_threads = _torch_threads(2, "two_torch_threads")
