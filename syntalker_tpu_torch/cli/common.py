"""Shared CLI plumbing: the base parser, config loading, logging, SMPL-X.

Counterpart of ``syntalker_tpu/cli/common.py``. ``load_smplx_if_available``
returns None where JAX's does (no path, or a path that does not exist);
a model it would load (``"synthetic"`` or an existing file) raises until
the port has ``ops/smplx.py``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from syntalker_tpu_torch.config import ExperimentConfig, load_config
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


def load_smplx_if_available(cfg: ExperimentConfig):
    p = cfg.data.smplx_model_path
    if p == "synthetic" or (p and Path(p).exists()):
        raise NotImplementedError(
            f"data.smplx_model_path={p!r}: SMPL-X forward kinematics (ops/smplx.py) is not ported yet; "
            "leave the path empty to build caches without foot contacts and h3d arrays")
    return None
