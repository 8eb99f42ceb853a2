"""Each cell at its own size on the card, a short window: correct, and the
control (the reference one precision below, in the program's place) not.
Skips without a CUDA device:

    python -m pytest -p no:cacheprovider -m cuda benchmark/tests/test_bench_card.py
"""

import time

import pytest
import torch

from benchmark import harness

pytestmark = pytest.mark.cuda
SHORT = {"beat2-stream": 3.0, "h3d-serve-prompted": 6.0}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run the hand-written kernels")
    return torch.device("cuda")


@pytest.mark.parametrize("name", sorted(SHORT))
def test_cell_at_its_size_and_its_control(card, name):
    ctx = harness.context(name, 20261018, SHORT[name], False, card, time.perf_counter())
    out = harness.drive(ctx, with_control=True)
    assert all(v <= limit for _, v, limit in out.checks), out.checks
    limits = ctx.cell["limits"]
    assert any(out.control[n] > limits[n] for n in limits if n in out.control), (out.control, limits)
