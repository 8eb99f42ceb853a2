"""One fixture for the port's test modules: torch's CPU thread pool sized
to this worker's share of the cores.

Under pytest-xdist each worker process runs its own torch, whose OpenMP
pool takes every core by default; with several workers on one machine the
pools spin against each other, and a test that takes one second alone
takes a minute. A module imports ``torch_threads_per_worker`` to give each
worker ``cores // workers`` threads while its tests run (all of them when
pytest runs without workers), restored after the module's last test.
"""

import os

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def torch_threads_per_worker():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    before = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)
