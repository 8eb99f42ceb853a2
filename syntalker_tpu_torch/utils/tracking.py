"""Logging, metric meters, epoch tracking, the trial CSV, seeds, timers and traces.

Counterpart of ``syntalker_tpu/utils/tracking.py``: ``setup_logging``,
``set_random_seed``, ``AverageMeter``, ``EpochTracker``, ``record_trial``,
``StepTimer``, ``TensorBoardWriter`` (a no-op without the tensorboard
package) and ``profile_trace``, which records a ``torch.profiler`` trace
where JAX's records a ``jax.profiler`` one.

The port's own tracer has no JAX counterpart: ``span(name, **attrs)``,
``record(name, start_ns, end_ns, **attrs)`` and ``count(name, n)`` at the
program's sites (the service's flushes, groups and requests, the samplers'
windows, encodes and steps, the decode, Whisper's transcription stages),
``enable()`` / ``disable()``, and
``drain()``, which hands over what was recorded. It is off by default, and
then a span or a count is one test of a module flag. On, a span keeps its
id, its parent (a stack per thread), its thread, its start and end on
``time.perf_counter_ns()`` and its attributes, in memory until ``drain()``;
while a ``torch.profiler`` records, it is also a ``record_function`` range
named ``syntalker.<name>``, so the kernels launched inside it belong to it
in the profiler's trace. ``enable()`` keeps one reading of the wall clock
beside ``perf_counter_ns()``: a span at ``t`` ns lies at
``wall_us(t, clock)`` µs, the clock of a profiler trace's ``ts`` plus its
``baseTimeNanoseconds`` / 1000.
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import itertools
import json
import logging
import random
import threading
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


# ---------------------------------------------------------------------------
# the program's tracer

_on = False  # the one thing a span or a count tests while the tracer is off
_profiler = None  # torch.autograd.profiler, imported by enable()
_ids = itertools.count(1)
_local = threading.local()
_lock = threading.Lock()
_spans: list = []
_counts: Dict[str, int] = {}
_clock = (0, 0)  # (time.time_ns(), time.perf_counter_ns()) read together by enable()


@dataclasses.dataclass(frozen=True)
class Span:
    """One span as recorded: ``parent`` 0 at the root of its thread,
    ``thread`` the OS thread id (a profiler trace's ``tid``), times in
    ``perf_counter_ns``."""

    id: int
    parent: int
    name: str
    thread: int
    start_ns: int
    end_ns: int
    attrs: dict


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _thread() -> tuple:
    """The calling thread's (span stack, OS thread id): the id is read once a
    thread, since reading it is a system call."""
    try:
        return _local.state
    except AttributeError:
        _local.state = ([], threading.get_native_id())
        return _local.state


class _Open:
    __slots__ = ("name", "attrs", "id", "parent", "thread", "start", "range")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack, self.thread = _thread()
        self.parent = stack[-1] if stack else 0
        self.id = next(_ids)
        stack.append(self.id)
        self.range = None
        if _profiler._is_profiler_enabled:
            self.range = _profiler.record_function("syntalker." + self.name)
            self.range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        _thread()[0].pop()
        _spans.append(Span(self.id, self.parent, self.name, self.thread, self.start, end, self.attrs))
        return False


def span(name: str, **attrs):
    """A context manager that records the region as the span ``name``."""
    if not _on:
        return _OFF
    return _Open(name, attrs)


def record(name: str, start_ns: int, end_ns: Optional[int] = None, **attrs) -> None:
    """Record a span whose start is already known (``perf_counter_ns``),
    ending at ``end_ns`` or now, as a child of the thread's open span."""
    if not _on:
        return
    if end_ns is None:
        end_ns = time.perf_counter_ns()
    stack, thread = _thread()
    _spans.append(Span(next(_ids), stack[-1] if stack else 0, name, thread, start_ns, end_ns, attrs))


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    if not _on:
        return
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def enable() -> None:
    """Start recording. With nothing held since the last :func:`drain`,
    read the wall clock beside ``perf_counter_ns``; otherwise keep the pair
    the held spans were recorded against."""
    global _on, _profiler, _clock
    from torch.autograd import profiler

    _profiler = profiler
    with profiler.record_function("syntalker.enable"):  # the first range's set-up, here rather than in a span
        pass
    if not _spans:
        _clock = (time.time_ns(), time.perf_counter_ns())
    _on = True


def disable() -> None:
    """Stop recording; what was recorded stays until :func:`drain`."""
    global _on
    _on = False


def drain() -> dict:
    """``{"spans": [Span], "counts": {name: n}, "clock": (time_ns,
    perf_counter_ns)}`` recorded since the last drain, then forgotten."""
    global _spans, _counts
    with _lock:
        spans, counts = _spans, _counts
        _spans, _counts = [], {}
    return {"spans": spans, "counts": counts, "clock": _clock}


def wall_us(t_ns: int, clock: tuple) -> float:
    """A ``perf_counter_ns`` reading on the wall clock, in µs, through the
    pair ``clock`` that :func:`enable` read."""
    return (clock[0] + t_ns - clock[1]) / 1e3


@contextlib.contextmanager
def profile_trace(log_dir: str | Path, enabled: bool = True):
    """A ``torch.profiler`` trace of the region (host, and the card when
    there is one) written as ``<log_dir>/trace.json`` (Chrome trace format),
    with the program's spans as ``syntalker.<name>`` ranges. Where the
    tracer was off, it is on for the region, and what it recorded is written
    as ``<log_dir>/spans.json`` (the spans with their attributes, the
    counters and the clock pair)."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    mine = not _on
    if mine:
        enable()
    try:
        with profile(activities=activities) as prof:
            yield
    finally:
        if mine:
            disable()
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))
    if mine:
        got = drain()
        got["spans"] = [dataclasses.asdict(s) for s in got["spans"]]
        (Path(log_dir) / "spans.json").write_text(json.dumps(got, default=str))
