"""Tests of the benchmark's own code, on the CPU (``gpu``-marked ones
decide inside the test whether a card is there).  Run from the root of the
checkout: ``python -m pytest portbench/tests -q``."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips (inside the test) where "
        "torch.cuda.is_available() is False")
