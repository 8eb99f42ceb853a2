"""The port's tracer (``utils/tracking.py``) and its sites in the service
and the samplers, on the CPU at tiny widths.

Off, a span site records nothing, enters no profiler range and reads no
clock, and the service's answers are bit for bit those of a run with the
tracer on. On, spans nest by thread, a request's spans share its
``request_id``, and one flush of the benchmark's eight-request pattern (3
unprompted, 2 upper-prompted, 3 hands+lower-prompted) makes one flush, three
groups, eight featurizations and eight queue waits, with 21 of the
denoiser's 64 sample rows real. Under a profiler each span is also a
``syntalker.<name>`` range, and the clock pair of ``enable()`` places the
recorded span on the range."""

import json
import threading
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from syntalker_tpu_torch.data.stats import identity_pose_stats
from syntalker_tpu_torch.diffusion.schedule import make_diffusion
from syntalker_tpu_torch.models.denoiser import MDMConfig, build_mdm
from syntalker_tpu_torch.models.rvqvae import RVQVAEConfig, build_rvqvae
from syntalker_tpu_torch.ops.quantize import RVQConfig
from syntalker_tpu_torch.serving import MotionGenerationService, MotionRequest
from syntalker_tpu_torch.utils import tracking
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse: the worker's share of the cores)

P = 8  # prompt width
CFG = MDMConfig(latent_total_dim=1536, latent_dim=32, ff_size=64, num_layers=1, num_heads=2, rope_heads=4,
                audio_feat_dim=16, word_feat_dim=16, word_embed_dim=8, vocab_size=50, use_prompt=True, prompt_dim=P)
PATTERN = [[], [], [], ["upper"], ["upper"], ["hands", "lower"], ["hands", "lower"], ["hands", "lower"]]
STEPS = 4
CLOCK_US = 500.0  # a recorded span against its profiler range, µs


@pytest.fixture(scope="module")
def models():
    q = RVQConfig(num_quantizers=2, nb_code=16, code_dim=512)
    rvq = {part: build_rvqvae(RVQVAEConfig(input_dim=dim, width=32, depth=1, quantizer=q), seed=i, device="cpu")
           for i, (part, dim) in enumerate((("upper", 78), ("hands", 180), ("lower", 57)))}
    return build_mdm(CFG, seed=0, device="cpu"), rvq


@pytest.fixture(autouse=True)
def tracer_off():
    tracking.disable()
    tracking.drain()
    yield
    tracking.disable()
    tracking.drain()


def requests():
    g = np.random.default_rng(5)
    return [MotionRequest(audio=g.normal(0, 0.1, int(16000 * (2 + 0.25 * j))).astype(np.float32),
                          words=g.integers(0, CFG.vocab_size, 60), request_id=f"r{j}",
                          prompts={p: g.normal(size=P).astype(np.float32) for p in parts} or None)
            for j, parts in enumerate(PATTERN)]


def flush(models, profiler=False):
    """One flush of the eight requests by a fresh service (same seed every
    time); with ``profiler``, under a CPU ``torch.profiler``, returned."""
    mdm, rvq = models
    svc = MotionGenerationService(mdm=mdm, diffusion=make_diffusion(steps=STEPS), rvq_modules=rvq,
                                  stats=identity_pose_stats(), max_batch=8, max_seconds=128 / 30, device="cpu",
                                  seed=3)
    for r in requests():
        svc.submit(r)
    if not profiler:
        return svc.flush(), None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = svc.flush()
    return out, prof


class CountingTime:
    """Stands in for the tracker's ``time`` module and counts clock reads."""

    def __init__(self):
        import time

        self.time, self.reads = time, 0

    def perf_counter_ns(self):
        self.reads += 1
        return self.time.perf_counter_ns()

    def time_ns(self):
        self.reads += 1
        return self.time.time_ns()


def test_off_records_nothing_enters_no_range_and_reads_no_clock(models, monkeypatch):
    entered = []
    base = torch.autograd.profiler.record_function

    class Counted(base):
        def __init__(self, name, *a, **kw):
            entered.append(name)
            super().__init__(name, *a, **kw)

    tracking.enable()  # the tracer has been on once, so its profiler module is bound
    tracking.disable()
    tracking.drain()
    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counted)
    clock = CountingTime()
    monkeypatch.setattr(tracking, "time", clock)
    out, prof = flush(models, profiler=True)  # a profiler records: still no range of the program's
    assert len(out) == 8
    assert not [n for n in entered if n.startswith("syntalker.")]
    assert not [e.name for e in prof.events() if e.name.startswith("syntalker.")]
    assert clock.reads == 0
    got = tracking.drain()
    assert got["spans"] == [] and got["counts"] == {}


def test_answers_are_the_same_with_the_tracer_on_and_off(models):
    off, _ = flush(models)
    tracking.enable()
    on, _ = flush(models)
    tracking.disable()
    assert tracking.drain()["spans"]
    assert [r.request_id for r in off] == [r.request_id for r in on]
    for a, b in zip(off, on):
        assert np.array_equal(a.axis_angle, b.axis_angle) and np.array_equal(a.trans, b.trans)


def test_a_flush_of_the_eight_request_pattern(models):
    tracking.enable()
    flush(models)
    tracking.disable()
    got = tracking.drain()
    spans = got["spans"]
    by_id = {s.id: s for s in spans}
    names = Counter(s.name for s in spans)
    [fl] = [s for s in spans if s.name == "serve.flush"]
    assert fl.parent == 0 and fl.attrs == {"requests": 8, "groups": 3}
    groups = [s for s in spans if s.name == "serve.group"]
    assert len(groups) == 3 and all(g.parent == fl.id for g in groups)
    assert [(g.attrs["key"] and g.attrs["key"][0], g.attrs["rows"], g.attrs["real"], g.attrs["branches"])
            for g in sorted(groups, key=lambda g: g.start_ns)] == [
        (None, 8, 3, 1), (("upper",), 8, 2, 3), (("hands", "lower"), 8, 3, 4)]
    features = [s for s in spans if s.name == "serve.features"]
    queued = [s for s in spans if s.name == "serve.queued"]
    assert len(features) == len(queued) == 8
    assert all(by_id[s.parent].name == "serve.group" for s in features)
    assert all(s.parent == fl.id and s.end_ns <= fl.start_ns + 10**6 and s.start_ns < s.end_ns for s in queued)
    ids = [f"r{j}" for j in range(8)]
    assert sorted(s.attrs["request_id"] for s in features) == sorted(s.attrs["request_id"] for s in queued) == ids
    for name in ("serve.stage", "serve.fetch", "serve.deliver", "decode", "sample.window", "sample.encode"):
        assert names[name] == 3, name
    assert all(by_id[s.parent].name == "serve.group" for s in spans if s.name in ("serve.stage", "decode"))
    assert sorted(s.attrs["branches"] for s in spans if s.name == "sample.encode") == [1, 3, 4]
    assert sorted(s.attrs["path"] for s in spans if s.name == "sample.window") == ["guided", "guided", "k1"]
    assert [s.attrs["rows"] for s in spans if s.name == "decode"] == [8, 8, 8]
    steps = [s for s in spans if s.name == "sample.step"]  # K1 runs its steps inside one kernel: no step spans
    assert len(steps) == 2 * STEPS and all(by_id[s.parent].attrs["path"] == "guided" for s in steps)
    for s in spans:  # every span inside its parent, on this thread
        assert s.thread == threading.get_native_id()
        if s.parent and s.name != "serve.queued":
            assert by_id[s.parent].start_ns <= s.start_ns <= s.end_ns <= by_id[s.parent].end_ns
    assert got["counts"] == {"serve.sample_rows": 64, "serve.sample_rows_real": 21, "serve.decode_rows": 24,
                             "serve.decode_rows_real": 8}
    assert got["counts"]["serve.sample_rows_real"] / got["counts"]["serve.sample_rows"] == 0.328125


def test_spans_nest_by_thread_and_counters_add():
    tracking.enable()
    with tracking.span("outer", request_id="a") as outer:
        with tracking.span("inner", request_id="a"):
            tracking.count("n")
            tracking.count("n", 4)
        tracking.record("waited", outer.start - 1000, request_id="a")
        tracking.record("given", 10, 20)
        seen = {}

        def other():
            with tracking.span("elsewhere"):
                pass
            seen["thread"] = threading.get_native_id()

        t = threading.Thread(target=other)
        t.start()
        t.join()
    with pytest.raises(ValueError), tracking.span("raised"):
        raise ValueError
    got = tracking.drain()
    s = {x.name: x for x in got["spans"]}
    assert s["outer"].parent == 0 and s["inner"].parent == s["outer"].id and s["waited"].parent == s["outer"].id
    assert s["elsewhere"].parent == 0 and s["elsewhere"].thread == seen["thread"] != s["outer"].thread
    assert s["raised"].parent == 0  # the stack was unwound
    assert (s["given"].start_ns, s["given"].end_ns) == (10, 20)
    assert s["waited"].end_ns - s["waited"].start_ns >= 1000
    assert {x.attrs.get("request_id") for x in (s["outer"], s["inner"], s["waited"])} == {"a"}
    assert got["counts"] == {"n": 5}
    assert tracking.drain()["spans"] == []
    tracking.disable()
    with tracking.span("after") as none:
        tracking.count("n")
    assert none is None and tracking.drain() == {"spans": [], "counts": {}, "clock": got["clock"]}


def test_spans_lie_on_their_profiler_ranges(models, tmp_path):
    tracking.enable()
    _, prof = flush(models, profiler=True)
    tracking.disable()
    got = tracking.drain()
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    trace = json.loads((tmp_path / "t.json").read_text())
    base_us = trace["baseTimeNanoseconds"] / 1e3
    ranges = sorted((e for e in trace["traceEvents"] if e.get("ph") == "X" and e["name"].startswith("syntalker.")
                     and e["name"] != "syntalker.enable"), key=lambda e: (e["ts"], -e["dur"]))
    spans = sorted((s for s in got["spans"] if s.name != "serve.queued"), key=lambda s: (s.start_ns, -s.end_ns))
    assert len(ranges) == len(spans) == 38
    starts = []
    for s, e in zip(spans, ranges):
        assert e["name"] == "syntalker." + s.name
        # the span is recorded inside its range; a thread descheduled between the two widens the range only
        start = tracking.wall_us(s.start_ns, got["clock"]) - base_us
        end = tracking.wall_us(s.end_ns, got["clock"]) - base_us
        assert e["ts"] - CLOCK_US < start <= end < e["ts"] + e["dur"] + CLOCK_US, s
        starts.append(abs(start - e["ts"]))
    assert np.median(starts) < CLOCK_US


def test_threads_lose_no_count_and_no_span():
    import sys

    n_threads, n = 16, 2000
    tracking.enable()
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n):
                with tracking.span("outer"):
                    with tracking.span("inner"):
                        tracking.count("n")

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(before)
    got = tracking.drain()
    assert got["counts"] == {"n": n_threads * n}
    by_id = {s.id: s for s in got["spans"]}
    assert len(by_id) == len(got["spans"]) == 2 * n_threads * n
    for s in got["spans"]:
        if s.name == "inner":
            assert by_id[s.parent].name == "outer" and by_id[s.parent].thread == s.thread
