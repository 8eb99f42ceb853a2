"""Logging setup for the command-line entry points.

Counterpart of ``setup_logging`` in ``syntalker_tpu/utils/tracking.py``;
the meters, timers and trial CSV wait for the training slice.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional


def setup_logging(run_dir: Optional[str | Path] = None, name: str = "syntalker"):
    """stdlib logging to the console, and to ``run_dir/log.txt`` when given."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s | %(levelname)s | %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if run_dir:
        Path(run_dir).mkdir(parents=True, exist_ok=True)
        fh = logging.FileHandler(Path(run_dir) / "log.txt")
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger
