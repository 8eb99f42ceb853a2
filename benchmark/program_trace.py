"""The program's own spans in a traced run: the profiler's ``syntalker.*``
ranges read together with what the port's tracer recorded
(``syntalker_tpu_torch.utils.tracking.drain()``).

A span of the program is recorded on ``perf_counter_ns``; while the
profiler records it is also a ``syntalker.<name>`` range of the trace.
:func:`read` places each recorded span on the trace's clock (the tracer's
clock pair and the trace's ``baseTimeNanoseconds``) and pairs it with its
range by name and start. Then:

- each range's host seconds, self seconds (less its children's) and device
  seconds: a kernel, copy or set belongs to the innermost range around the
  host call that launched it on the launching thread, matched by the
  profiler's correlation id (a CUDA graph's kernels carry their replay's);
- each device-idle interval of the traced window split over the whole
  interval by the service thread's innermost range: time inside a leaf
  range (one with no range inside it) goes to that range's name, the rest
  (a parent's own time between its children, or no range) to ``unnamed``,
  itself split by that parent's name (``-`` for none);
- the recorded spans of the flushes that ran with the profiler off (a
  ``serve.flush`` with no range), for host times free of its cost, also
  those inside prompted groups (``serve.group`` with more than one branch);
- the tracer's counters;
- with a configuration, K2's bound over the prompted groups' profiled
  steps (``k2_bound_s`` at each group's ``branches`` x ``rows``).

The benchmark's spans (``bench.*``) are read by :mod:`benchmark.tracing`,
whose helpers this module uses and leaves as they are.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses

from benchmark import roofline
from benchmark.tracing import DEVICE_CATS, WINDOW, _union

PREFIX = "syntalker."
MATCH_US = 1000.0  # a recorded span and its range start within this of each other
UNNAMED = "unnamed"


def _as_dict(span) -> dict:
    return span if isinstance(span, dict) else dataclasses.asdict(span)


def _stat():
    return {"calls": 0, "host_s": 0.0}


def _ranges(xs: list, w0: float, w1: float) -> list:
    """The program's ranges that start inside the window, sorted by start:
    dicts of name, thread, start and end (µs)."""
    out = [{"name": e["name"][len(PREFIX):], "tid": e.get("tid"), "s": e["ts"], "e": e["ts"] + e["dur"]}
           for e in xs if e.get("cat") == "user_annotation" and e.get("name", "").startswith(PREFIX)
           and e["name"] != PREFIX + "enable" and w0 <= e["ts"] <= w1]
    out.sort(key=lambda r: (r["s"], -r["e"]))
    return out


def _nest(ranges: list) -> None:
    """Each range's parent index on its thread (``parent``), and whether
    another range lies inside it (``leaf``); ranges sorted by start."""
    open_by_tid = collections.defaultdict(list)
    for i, r in enumerate(ranges):
        stack = open_by_tid[r["tid"]]
        while stack and ranges[stack[-1]]["e"] <= r["s"]:
            stack.pop()
        r["parent"] = stack[-1] if stack else None
        r["leaf"] = True
        if stack:
            ranges[stack[-1]]["leaf"] = False
        stack.append(i)


def _match(ranges: list, records: list, offset_us: float) -> None:
    """Pair each range with the recorded span of its name whose start, on
    the trace's clock, is nearest (within ``MATCH_US``): ``record``."""
    by_name = collections.defaultdict(list)
    for rec in records:
        by_name[rec["name"]].append(rec)
    starts = {}
    for name, recs in by_name.items():
        recs.sort(key=lambda r: r["start_ns"])
        starts[name] = [r["start_ns"] / 1e3 + offset_us for r in recs]
    used = set()
    for r in ranges:
        recs, st = by_name.get(r["name"], []), starts.get(r["name"], [])
        k = bisect.bisect_left(st, r["s"])
        best = None
        for j in (k - 1, k, k + 1):
            if 0 <= j < len(st) and recs[j]["id"] not in used and abs(st[j] - r["s"]) <= MATCH_US:
                if best is None or abs(st[j] - r["s"]) < abs(st[best] - r["s"]):
                    best = j
        r["record"] = None if best is None else recs[best]
        if best is not None:
            used.add(recs[best]["id"])


def _innermost(ranges: list, of_tid: list, starts: list, t: float):
    """The innermost range of one thread open at t (``of_tid``: the
    thread's range indices, ``starts`` their starts): the latest started
    before t, or the nearest of its ancestors that is still open."""
    k = bisect.bisect_right(starts, t) - 1
    r = ranges[of_tid[k]] if k >= 0 else None
    while r is not None and not r["s"] <= t <= r["e"]:
        r = None if r["parent"] is None else ranges[r["parent"]]
    return r


def _timeline(ranges: list, of_tid: list) -> list:
    """Elementary segments (start, end, innermost range or None) of one
    thread."""
    starts = [ranges[i]["s"] for i in of_tid]
    pts = sorted({ranges[i]["s"] for i in of_tid} | {ranges[i]["e"] for i in of_tid})
    return [(a, b, _innermost(ranges, of_tid, starts, 0.5 * (a + b))) for a, b in zip(pts, pts[1:])]


def read(trace: dict, drained: dict, config: dict = None) -> dict:
    """The program's spans in ``trace`` (a profiler trace's JSON object)
    with the tracer's ``drained`` records; ``config`` a configuration
    file's contents, for K2's bound. Empty where the trace holds no window
    or the tracer recorded nothing."""
    xs = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    win = [e for e in xs if e.get("name") == WINDOW]
    records = [_as_dict(s) for s in drained.get("spans", [])]
    if not win or not records:
        return {}
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    clock = drained["clock"]
    # a perf_counter_ns reading at t: wall µs (t - clock[1] + clock[0]) / 1e3, trace µs less the base
    offset_us = (clock[0] - clock[1]) / 1e3 - trace.get("baseTimeNanoseconds", 0) / 1e3
    ranges = _ranges(xs, w0, w1)
    _nest(ranges)
    _match(ranges, records, offset_us)
    by_id = {r["id"]: r for r in records}

    def ancestor(rec, name):
        while rec is not None and rec["name"] != name:
            rec = by_id.get(rec["parent"])
        return rec

    def prompted(rec) -> bool:
        """Inside a group of more than one guidance branch."""
        group = ancestor(rec, "serve.group")
        return group is not None and group["attrs"].get("branches", 1) > 1

    # device time of each range's kernels
    of_tid = collections.defaultdict(list)
    for i, r in enumerate(ranges):
        of_tid[r["tid"]].append(i)
    tid_starts = {tid: [ranges[i]["s"] for i in idx] for tid, idx in of_tid.items()}
    launch = {e["args"]["correlation"]: (e["ts"], e.get("tid")) for e in xs
              if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {})}
    spans = collections.defaultdict(lambda: {"calls": 0, "host_s": 0.0, "self_s": 0.0, "device_s": 0.0,
                                             "idle_s": 0.0})
    prompted_dev = 0.0
    dev = []
    for e in xs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        s, t = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if t <= s:
            continue
        dev.append((s, t))
        lt = launch.get(e.get("args", {}).get("correlation"))
        r = None if lt is None or lt[1] not in of_tid else _innermost(ranges, of_tid[lt[1]], tid_starts[lt[1]], lt[0])
        if r is None:
            continue
        spans[r["name"]]["device_s"] += (t - s) * 1e-6
        if r["name"] == "sample.step" and prompted(r["record"]):
            prompted_dev += (t - s) * 1e-6

    for r in ranges:
        d = spans[r["name"]]
        d["calls"] += 1
        d["host_s"] += (r["e"] - r["s"]) * 1e-6
        d["self_s"] += (r["e"] - r["s"]) * 1e-6
        if r["parent"] is not None:
            spans[ranges[r["parent"]]["name"]]["self_s"] -= (r["e"] - r["s"]) * 1e-6

    # the device's idle intervals, split by the service thread's leaf ranges
    busy = _union(dev)
    idle, prev = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            idle.append((prev, s))
        prev = max(prev, e)
    flush_tids = collections.Counter(r["tid"] for r in ranges if r["name"] == "serve.flush")
    split, unnamed_in = collections.Counter(), collections.Counter()
    if flush_tids:
        segs = _timeline(ranges, of_tid[flush_tids.most_common(1)[0][0]])
        seg_ends = [g[1] for g in segs]
        for a, b in idle:
            covered = 0.0
            for s, e, r in segs[bisect.bisect_right(seg_ends, a):]:
                if s >= b:
                    break
                part = min(b, e) - max(a, s)
                if part > 0:
                    covered += part
                    if r is not None and r["leaf"]:
                        split[r["name"]] += part * 1e-6
                        spans[r["name"]]["idle_s"] += part * 1e-6
                    else:
                        unnamed_in["-" if r is None else r["name"]] += part * 1e-6
            unnamed_in["-"] += (b - a - covered) * 1e-6
        split[UNNAMED] = sum(unnamed_in.values())

    # the flushes the profiler did not see
    seen = {r["record"]["id"] for r in ranges if r["record"] is not None}
    free_flushes = {rec["id"] for rec in records if rec["name"] == "serve.flush" and rec["id"] not in seen}
    free, free_prompted = collections.defaultdict(_stat), collections.defaultdict(_stat)
    for rec in records:
        flush = ancestor(rec, "serve.flush")
        if flush is None or flush["id"] not in free_flushes:
            continue
        for into in (free, free_prompted) if prompted(rec) else (free,):
            into[rec["name"]]["calls"] += 1
            into[rec["name"]]["host_s"] += (rec["end_ns"] - rec["start_ns"]) * 1e-9

    out = {"spans": {k: dict(v) for k, v in spans.items()}, "free": dict(free), "free_prompted": dict(free_prompted),
           "counts": dict(drained.get("counts", {})), "flushes": {"profiled": flush_tids.total(),
                                                                   "free": len(free_flushes)},
           "idle_s": sum(b - a for a, b in idle) * 1e-6, "idle_split": dict(split) if flush_tids else {},
           "unnamed_in": dict(unnamed_in),
           "prompted_step_device_s": prompted_dev}
    if config is not None:
        groups = [ancestor(r["record"], "serve.group") for r in ranges
                  if r["name"] == "sample.step" and prompted(r["record"])]
        m, t = config["mdm"], config["pose_length"] // 4
        out["k2_step_bound_s"] = sum(roofline.k2_bound_s(m, g["attrs"]["branches"] * g["attrs"]["rows"], t)
                                     for g in groups)
    return out
