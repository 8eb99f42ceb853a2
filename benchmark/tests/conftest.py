"""Tests of the benchmark itself, beside it so that they travel with it:

    python -m pytest -p no:cacheprovider benchmark/tests

They import no JAX. Tests that need the card are marked ``cuda`` and skip
without one (decided in a fixture)."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skips without one")
