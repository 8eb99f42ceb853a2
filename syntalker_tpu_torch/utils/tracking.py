"""Logging, metric meters, epoch tracking, the trial CSV, seeds, timers and traces.

Counterpart of ``syntalker_tpu/utils/tracking.py``: ``setup_logging``,
``set_random_seed``, ``AverageMeter``, ``EpochTracker``, ``record_trial``,
``StepTimer``, ``TensorBoardWriter`` (a no-op without the tensorboard
package) and ``profile_trace``, which records a ``torch.profiler`` trace
where JAX's records a ``jax.profiler`` one.
"""

from __future__ import annotations

import contextlib
import csv
import json
import logging
import random
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Optional

import numpy as np


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


def set_random_seed(seed: int):
    """Python's and numpy's global seeds (other_tools.py:746-756). The
    port's own draws come from explicit ``torch.Generator``s, so torch's
    global seed is left alone."""
    random.seed(seed)
    np.random.seed(seed)


class AverageMeter:
    def __init__(self):
        self.sum = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1):
        self.sum += float(value) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)

    def reset(self):
        self.sum = 0.0
        self.count = 0


class EpochTracker:
    """Per-metric train/val/test meters with best-value tracking
    (other_tools.py:639-730). `higher_is_better[metric]` drives best-ckpt
    decisions like the reference's paired boolean list."""

    SPLITS = ("train", "val", "test")

    def __init__(self, higher_is_better: Optional[Dict[str, bool]] = None):
        self.higher = higher_is_better or {}
        self.meters: Dict[str, Dict[str, AverageMeter]] = defaultdict(
            lambda: {s: AverageMeter() for s in self.SPLITS}
        )
        self.best: Dict[str, Dict[str, float]] = defaultdict(dict)
        self.history: list = []

    def update(self, metric: str, split: str, value: float, n: int = 1):
        self.meters[metric][split].update(value, n)

    def end_epoch(self, epoch: int) -> Dict[str, float]:
        """Snapshot averages, update bests, reset meters. Returns flat dict."""
        flat = {}
        improved = {}
        for metric, by_split in self.meters.items():
            for split, meter in by_split.items():
                if meter.count == 0:
                    continue
                v = meter.avg
                flat[f"{split}/{metric}"] = v
                hib = self.higher.get(metric, False)
                best = self.best[metric].get(split)
                if best is None or (v > best if hib else v < best):
                    self.best[metric][split] = v
                    improved[f"{split}/{metric}"] = v
                meter.reset()
        self.history.append({"epoch": epoch, **flat})
        return {**flat, "_improved": improved}

    def save_history(self, path: str | Path):
        Path(path).write_text(json.dumps(self.history, indent=1))


def record_trial(csv_path: str | Path, row: Dict):
    """Append a flattened config+metrics row (other_tools.py:731-745)."""
    p = Path(csv_path)
    exists = p.exists()
    p.parent.mkdir(parents=True, exist_ok=True)
    with open(p, "a", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(row))
        if not exists:
            w.writeheader()
        w.writerow(row)


class StepTimer:
    """Tracks data-wait vs compute time per step (the reference's manual
    t_data/t_train split, diffusion_rvqvae_trainer.py:551-566)."""

    def __init__(self):
        self.t = time.perf_counter()
        self.data_s = 0.0
        self.step_s = 0.0

    def mark_data(self):
        now = time.perf_counter()
        self.data_s = now - self.t
        self.t = now

    def mark_step(self):
        now = time.perf_counter()
        self.step_s = now - self.t
        self.t = now


class TensorBoardWriter:
    """Scalar logging to TensorBoard (the reference's ``stat: ts`` path). A
    no-op when ``torch.utils.tensorboard`` cannot be imported (it needs the
    tensorboard package)."""

    def __init__(self, log_dir: str | Path):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            self._w = None
        else:
            self._w = SummaryWriter(str(log_dir))

    def scalar(self, tag: str, value: float, step: int):
        if self._w is not None:
            self._w.add_scalar(tag, value, step)

    def flush(self):
        if self._w is not None:
            self._w.flush()


@contextlib.contextmanager
def profile_trace(log_dir: str | Path, enabled: bool = True):
    """A ``torch.profiler`` trace of the region (host, and the card when
    there is one) written as ``<log_dir>/trace.json`` (Chrome trace format)."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))
