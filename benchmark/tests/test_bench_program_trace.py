"""``benchmark/program_trace.py`` and the readers of the program's spans on
a synthetic trace: the service's thread in a flush (a group, a request's
featurization, the staging, a guided step whose CUDA graph runs after the
step's host range has closed) and the device busy around two idle gaps; the
tracer's records of that flush and of one the profiler did not see."""

import json
from pathlib import Path

import pytest

from benchmark import harness, program_trace, roofline

CONFIG = json.loads((Path(__file__).resolve().parents[1] / "configs" / "h3d.json").read_text())
MAIN, SERVICE = 1, 2
READERS = ("queue_wait_ms.serve", "real_rows.serve", "features_span_ms.serve", "guided_denoise_ms.serve",
           "cond_encode_ms.serve", "k2_step_roofline.serve", "idle_in_features.serve", "idle_unnamed.serve")


def rng(name, ts, end, tid=SERVICE):
    return {"ph": "X", "cat": "user_annotation", "name": name, "tid": tid, "ts": ts, "dur": end - ts}


def launch(ts, corr, name="cudaLaunchKernel", tid=SERVICE):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "tid": tid, "ts": ts, "dur": 5,
            "args": {"correlation": corr}}


def kernel(ts, end, corr):
    return {"ph": "X", "cat": "kernel", "name": f"k{corr}", "tid": 7, "ts": ts, "dur": end - ts,
            "args": {"correlation": corr}}


# the profiled flush: (name, start, end, parent, attrs), µs on the trace's clock
PROFILED = [("serve.flush", 100, 9000, None, {"requests": 1, "groups": 1}),
            ("serve.group", 200, 8800, "serve.flush", {"key": ["upper"], "rows": 8, "real": 1, "branches": 3}),
            ("serve.features", 300, 2000, "serve.group", {"request_id": "a"}),
            ("serve.stage", 2000, 4000, "serve.group", {}),
            ("sample.step", 5000, 6000, "serve.group", {})]
# one the profiler did not see, after the window
FREE = [("serve.flush", 20000, 30000, None, {"requests": 1, "groups": 1}),
        ("serve.queued", 19000, 20000, "serve.flush", {"request_id": "b"}),
        ("serve.group", 20100, 29000, "serve.flush", {"key": ["upper"], "rows": 8, "real": 1, "branches": 3}),
        ("serve.features", 20200, 23200, "serve.group", {"request_id": "b"}),
        ("sample.encode", 23200, 23700, "serve.group", {"branches": 3}),
        ("sample.step", 24000, 26000, "serve.group", {}),
        ("sample.step", 26000, 27000, "serve.group", {})]


def drained(spans):
    """The records, a parent the latest span of its name before."""
    latest, out = {}, []
    for i, (name, s, e, parent, attrs) in enumerate(spans, 1):
        out.append({"id": i, "parent": latest[parent] if parent else 0, "name": name, "thread": SERVICE,
                    "start_ns": s * 1000, "end_ns": e * 1000, "attrs": attrs})
        latest[name] = i
    return out


def events():
    ev = [rng("bench.window", 0, 10000, MAIN)]
    ev += [rng("syntalker." + name, s, e) for name, s, e, _, _ in PROFILED]
    ev += [launch(50, 1, tid=MAIN), kernel(0, 1000, 1),  # busy, then idle 1000-3000 over features and stage
           launch(2500, 2), kernel(3000, 5000, 2),  # launched by the staging
           launch(4500, 3), kernel(5000, 6500, 3),  # by the group between its children
           launch(5100, 4, "cudaGraphLaunch"), kernel(6500, 7000, 4), kernel(7000, 8000, 4),  # the step's graph
           launch(5500, 5), kernel(8000, 8900, 5),  # idle 8900-9500: the flush's own time, then no span
           launch(9400, 6, tid=MAIN), kernel(9500, 10000, 6)]
    # the tracer's clock pair and the trace's base put a recorded ns at the trace's µs x 1000
    return {"traceEvents": ev, "baseTimeNanoseconds": 5_000_000_000}


def summary():
    return {"program": program_trace.read(events(), {"spans": drained(PROFILED + FREE), "clock": (5_000_000_000, 0),
                                                     "counts": {"serve.sample_rows": 64, "serve.sample_rows_real": 21}},
                                          config=CONFIG)}


def test_an_idle_gap_is_split_over_the_leaf_spans_it_spans():
    p = summary()["program"]
    assert p["idle_s"] == pytest.approx(2600e-6)
    assert p["idle_split"] == pytest.approx({"serve.features": 1000e-6, "serve.stage": 1000e-6, "unnamed": 600e-6})
    assert p["spans"]["serve.features"]["idle_s"] == pytest.approx(1000e-6)
    assert p["unnamed_in"] == pytest.approx({"serve.flush": 100e-6, "-": 500e-6})  # the flush's own time, none


def test_a_graph_replay_belongs_to_its_span_by_correlation():
    p = summary()["program"]
    assert p["spans"]["sample.step"]["device_s"] == pytest.approx(2400e-6)  # the replay's two kernels and one more
    assert p["prompted_step_device_s"] == pytest.approx(2400e-6)
    assert p["spans"]["serve.stage"]["device_s"] == pytest.approx(2000e-6)
    assert p["spans"]["serve.group"]["device_s"] == pytest.approx(1500e-6)
    assert p["spans"]["serve.group"]["self_s"] == pytest.approx((8600 - 1700 - 2000 - 1000) * 1e-6)
    assert p["k2_step_bound_s"] == pytest.approx(roofline.k2_bound_s(CONFIG["mdm"], 24, 32))


def test_the_flush_without_the_profiler_gives_the_host_times():
    p = summary()["program"]
    assert p["flushes"] == {"profiled": 1, "free": 1}
    assert p["free"]["serve.features"] == {"calls": 1, "host_s": pytest.approx(3e-3)}
    assert p["free_prompted"]["sample.step"] == {"calls": 2, "host_s": pytest.approx(3e-3)}
    s = summary()
    got = {name: harness.read_metric(name, s) for name in READERS}
    assert got == pytest.approx({
        "queue_wait_ms.serve": 1.0, "real_rows.serve": 32.8125, "features_span_ms.serve": 3.0,
        "guided_denoise_ms.serve": 1.5, "cond_encode_ms.serve": 0.5,
        "k2_step_roofline.serve": 100 * roofline.k2_bound_s(CONFIG["mdm"], 24, 32) / 2400e-6,
        "idle_in_features.serve": 100 * 1000 / 2600, "idle_unnamed.serve": 100 * 600 / 2600})


@pytest.mark.parametrize("name", READERS)
def test_each_reader_finds_nothing_without_the_programs_spans(name):
    assert harness.read_metric(name, {}) is None
    assert harness.read_metric(name, {"program": {}}) is None
    empty = program_trace.read(events(), {"spans": [], "clock": (0, 0), "counts": {}})
    assert harness.read_metric(name, {"program": empty}) is None
    no_window = program_trace.read({"traceEvents": events()["traceEvents"][1:]},
                                   {"spans": drained(PROFILED), "clock": (0, 0), "counts": {}})
    assert harness.read_metric(name, {"program": no_window}) is None
