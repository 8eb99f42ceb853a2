"""The benchmark's spans and the reading of a device trace.

Spans are the benchmark's own: :class:`Hooks` wraps a function of the
program that a layer's work goes through, and while a traced window is open
records each call as a ``torch.profiler.record_function`` range named
``bench.<span>``, with a shape of its arguments where the reader of a
metric needs one. The same wrapper can keep what a call returned or was
handed, for the judge, in every run.

:func:`analyze` reads the profiler's trace: the traced window (the range
``bench.window``), the device's busy time (the union of kernel, copy and
set intervals), the device time of the kernels each span launched (a
kernel belongs to the innermost span around the host call that launched
it, matched by the profiler's correlation id; a CUDA graph's kernels carry
their replay's id), the longest idle gaps named by the span the host was in
(``host:<span>``), and the kernels that took most time.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile
import time

import torch

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Hooks:
    """Wrappers around functions of the program, undone by :meth:`restore`."""

    def __init__(self):
        self.tracing = False
        self.calls = collections.defaultdict(list)  # span -> [shape] of calls made while tracing
        self._undo = []

    def wrap(self, owner, attr: str, span: str = None, shape=None, keep=None):
        """Replace ``owner.attr``. ``span``: record calls while tracing, and
        ``shape(*args, **kw)`` of each; ``keep(result, *args, **kw)``: called
        after every call."""
        orig = getattr(owner, attr)
        hooks = self

        def wrapper(*args, **kw):
            if span is None or not hooks.tracing:
                out = orig(*args, **kw)
            else:
                with torch.profiler.record_function(f"bench.{span}"):
                    out = orig(*args, **kw)
                hooks.calls[span].append(shape(*args, **kw) if shape else None)
            if keep is not None:
                keep(out, *args, **kw)
            return out

        setattr(owner, attr, wrapper)
        self._undo.append((owner, attr, orig))

    def restore(self):
        while self._undo:
            owner, attr, orig = self._undo.pop()
            setattr(owner, attr, orig)


def warm_profiler() -> None:
    """Start the profiler's device tracing once at set-up: its first start
    takes seconds."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


class TracedWindow:
    """The profiler around a stretch of the run: ``start()``, the work,
    ``stop()`` (both from the thread that started the run); then
    :meth:`summary`."""

    def __init__(self, hooks: Hooks):
        from torch.profiler import ProfilerActivity, profile

        self.hooks = hooks
        try:  # the host ranges of every thread, the service's too
            from torch._C._profiler import _ExperimentalConfig

            config = {"experimental_config": _ExperimentalConfig(profile_all_threads=True)}
        except (ImportError, TypeError):
            config = {}
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], **config)
        self.wall_s = 0.0
        self.state = "ready"  # then "on", then "done"

    def start(self):
        self.state = "on"
        torch.cuda.synchronize()
        self.prof.start()
        self._range = torch.profiler.record_function(WINDOW)
        self._range.__enter__()
        self.hooks.calls.clear()
        self.hooks.tracing = True
        self._t0 = time.perf_counter()

    def stop(self):
        torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self._t0
        self.hooks.tracing = False
        self._range.__exit__(None, None, None)
        self.prof.stop()
        self.state = "done"

    def summary(self) -> dict:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        out = analyze(events)
        out["span_shapes"] = dict(self.hooks.calls)
        out["wall_s"] = self.wall_s
        return out


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _covered(busy, ends, s, e) -> float:
    """How much of [s, e] the sorted disjoint intervals ``busy`` cover."""
    total = 0.0
    for b0, b1 in busy[bisect.bisect_left(ends, s):]:
        if b0 >= e:
            break
        total += min(e, b1) - max(s, b0)
    return total


def analyze(events: list) -> dict:
    """Numbers of the traced window from the profiler's chrome-trace events
    (times in microseconds there, seconds here)."""
    xs = [e for e in events if e.get("ph") == "X"]
    win = [e for e in xs if e.get("name") == WINDOW]
    if not win:
        return {}
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    spans = sorted(((e["ts"], e["ts"] + e["dur"], e["name"][len("bench."):]) for e in xs
                    if e.get("cat") == "user_annotation" and e["name"].startswith("bench.") and e["name"] != WINDOW),
                   key=lambda s: s[0])
    starts = [s[0] for s in spans]

    def span_at(t):
        """The innermost span open at host time t (the latest started)."""
        for k in range(bisect.bisect_right(starts, t) - 1, max(-1, bisect.bisect_right(starts, t) - 64), -1):
            if spans[k][0] <= t <= spans[k][1]:
                return spans[k][2]
        return None

    launch = {e["args"]["correlation"]: e["ts"] for e in xs
              if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {})}
    dev, span_dev, ops = [], collections.Counter(), collections.Counter()
    kernels = 0
    for e in xs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        s, t = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if t <= s:
            continue
        dev.append((s, t))
        ops[e["name"]] += (t - s) * 1e-6
        kernels += e.get("cat") == "kernel"
        lt = launch.get(e.get("args", {}).get("correlation"))
        name = span_at(lt) if lt is not None else None
        span_dev[name or "other"] += (t - s) * 1e-6
    busy = _union(dev)
    gaps, prev = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            gaps.append(((s - prev) * 1e-6, f"host:{span_at(prev) or 'other'}"))
        prev = max(prev, e)
    span_host, span_n, span_idle = collections.Counter(), collections.Counter(), collections.Counter()
    ends = [b[1] for b in busy]
    for s, e, n in spans:
        if w0 <= s <= w1:
            span_host[n] += (e - s) * 1e-6
            span_n[n] += 1
            span_idle[n] += (e - s - _covered(busy, ends, s, e)) * 1e-6
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "kernels": kernels,
        "span_device_s": dict(span_dev),
        "span_host_s": dict(span_host),
        "span_calls": dict(span_n),
        "span_idle_s": dict(span_idle),
        "device_ops": [[n, v] for n, v in ops.most_common(10)],
        "idle_gaps": [[n, v] for v, n in sorted(gaps, reverse=True)[:10]],
    }


def breakdown(summary: dict) -> dict:
    return {"device_ops": summary.get("device_ops", []), "idle_gaps": summary.get("idle_gaps", [])}
