"""Shared CLI plumbing: the base parser, config loading and logging.

Counterpart of ``base_parser`` and ``setup`` in
``syntalker_tpu/cli/common.py``; loading an SMPL-X model waits for the
port of ``ops/smplx.py``.
"""

from __future__ import annotations

import argparse

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
