"""Process groups for multi-GPU training.

Counterpart of ``syntalker_tpu/parallel/multihost.py``. JAX starts one
process per host and the runtime finds the pod; PyTorch's idiom is one
process per device over ``torch.distributed``. :func:`init_multihost` starts
the group once per process, before any model is built: with its arguments,
or from the ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT``
that ``torchrun`` sets (``torchrun --nproc_per_node=N -m
syntalker_tpu_torch.cli.train ...``). One process is no group and nothing
to start.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

log = logging.getLogger("syntalker")


def group_started() -> bool:
    return dist.is_available() and dist.is_initialized()


def local_device() -> torch.device:
    """This process's device: ``cuda:<LOCAL_RANK>`` (torchrun's, else the
    rank modulo the visible cards) under a group with CUDA, the current
    card in a single process, the CPU without CUDA."""
    if not torch.cuda.is_available():
        return torch.device("cpu")
    if not group_started():
        return torch.device("cuda", torch.cuda.current_device())
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local is not None else dist.get_rank() % torch.cuda.device_count()
    return torch.device("cuda", index)


def _backend(backend: Optional[str]) -> str:
    if backend is None:
        return "nccl" if torch.cuda.is_available() else "gloo"
    available = {"nccl": dist.is_nccl_available() and torch.cuda.is_available(), "gloo": dist.is_gloo_available()}
    if not available.get(backend, False):
        raise RuntimeError(f"backend {backend!r} is not available on this machine")
    return backend


def init_multihost(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
                   process_id: Optional[int] = None, *, backend: Optional[str] = None) -> dict:
    """Start the process group when running multi-process; a no-op for a
    single process. ``coordinator_address`` is ``host:port`` (or any
    ``init_method`` URL: ``tcp://``, ``file://``); without arguments the
    torchrun environment decides. The backend is ``nccl`` with CUDA and
    ``gloo`` without, unless named; a named backend the machine lacks
    raises. Under a group with CUDA the current card becomes this rank's.
    Returns the topology, as JAX's does."""
    if not group_started():
        if num_processes is None and int(os.environ.get("WORLD_SIZE", "1")) > 1:
            dist.init_process_group(_backend(backend), init_method="env://")
        elif num_processes and num_processes > 1:
            if coordinator_address is None or process_id is None:
                raise ValueError("a group of several processes needs coordinator_address and process_id")
            url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
            dist.init_process_group(_backend(backend), init_method=url, world_size=num_processes, rank=process_id)
        if group_started() and torch.cuda.is_available():
            torch.cuda.set_device(local_device())
    grouped = group_started()
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 1
    info = {
        "process_index": dist.get_rank() if grouped else 0,
        "process_count": dist.get_world_size() if grouped else 1,
        "local_devices": 1 if grouped else cards,
        "global_devices": dist.get_world_size() if grouped else cards,
    }
    log.info(f"topology: {info}")
    return info


def is_primary() -> bool:
    """The rank-0 gate for host-side side effects (cache builds, logs,
    checkpoint writes); true without a group."""
    return not group_started() or dist.get_rank() == 0
