"""Each cell's driver end to end at tiny widths on the CPU (the kernels'
plain versions), judged with the cell's own limits: a sound run is
correct; the control (the reference one precision below the program, in
its place) and each fault the cell can have, planted in the timed path,
come out not correct.

The faults (``benchmark/faults.py``): a step that leaves its state
unchanged; half the batch left out; a motion answer altered where the
decode produces it. One chip runs each cell, so no exchange between chips
can be left out, and a one-stream cell has no batch to halve."""

import json

import pytest

from benchmark.tests import tiny
from benchmark import faults, harness

CELLS = ("beat2-stream", "h3d-serve-prompted")


MANIFEST = json.loads((harness.BENCH.parent / "BENCHMARK.json").read_text())


def line(ctx, out):
    return harness.result(ctx, out, MANIFEST, {"platform": "cpu"})


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct_and_the_control_is_not(name):
    ctx = tiny.ctx(name, seed=11)
    out = harness.drive(ctx, with_control=True)
    res = line(ctx, out)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    e2e, _ = harness.cell_metrics(MANIFEST, name)
    assert set(res["metrics"]) == {m["name"] for m in e2e}
    limits = ctx.cell["limits"]
    assert any(out.control[n] > limits[n] for n in limits), (out.control, limits)


CELL_FAULTS = {"beat2-stream": ("unchanged_state", "altered_answer"),
               "h3d-serve-prompted": ("unchanged_state", "half_batch", "altered_answer")}
CASES = [(c, f) for c, fs in CELL_FAULTS.items() for f in fs]


@pytest.mark.parametrize("name,fault", CASES, ids=[f"{c}-{f}" for c, f in CASES])
def test_a_fault_in_the_timed_path_is_not_correct(name, fault, monkeypatch):
    faults.FAULTS[fault](monkeypatch.setattr)
    ctx = tiny.ctx(name, seed=12)
    res = line(ctx, harness.drive(ctx))
    assert not res["correct"], res["checks"]
