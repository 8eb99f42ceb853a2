"""Shared CLI plumbing: the base parser, config loading, logging, SMPL-X.

Counterpart of ``syntalker_tpu/cli/common.py``. ``load_smplx_if_available``
has JAX's three outcomes: the synthetic stand-in model for ``"synthetic"``,
the released npz for a path that exists, else None; the model's tensors
go to ``device``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch.distributed as dist

from syntalker_tpu_torch.config import ExperimentConfig, load_config
from syntalker_tpu_torch.parallel.multihost import group_started, is_primary
from syntalker_tpu_torch.ops.smplx import load_smplx_npz, synthetic_smplx_model
from syntalker_tpu_torch.utils.tracking import setup_logging


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("-c", "--config", type=str, default=None, help="YAML config path")
    p.add_argument("overrides", nargs="*", default=[], help="dot-path config overrides, e.g. train.lr=1e-4")
    p.add_argument("--run-dir", type=str, default="./outputs/run")
    return p


def setup(args) -> ExperimentConfig:
    setup_logging(args.run_dir)
    return load_config(args.config, args.overrides)


def load_smplx_if_available(cfg: ExperimentConfig, device=None):
    p = cfg.data.smplx_model_path
    if p == "synthetic":
        # geometry-plausible stand-in: h3d features and joint metrics run, but
        # the joints are not the released body's
        return synthetic_smplx_model(device=device)
    if p and Path(p).exists():
        return load_smplx_npz(p, device=device)
    return None


def primary_first(build):
    """``build()`` on the primary rank, then, once it is done, on the
    others (which reuse what it wrote: a window cache); just ``build()``
    without a process group."""
    out = build() if is_primary() else None
    if group_started():
        dist.barrier()
        if not is_primary():
            out = build()
    return out
