"""The benchmark's own tests: on the CPU at small sizes, and, marked
``cuda``, on the card (they decide inside the test whether there is one).

    python -m pytest l3bench/tests -q            # CPU; the cuda tests skip
    python -m pytest l3bench/tests -q -m cuda    # on the card
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")
