"""The harness finds cells, configurations, traffic and metric readers by
name, and writes the result line the manifest's contract asks for."""

import json
import shutil

import pytest
import torch

from benchmark import harness

MANIFEST = json.loads((harness.BENCH.parent / "BENCHMARK.json").read_text())


@pytest.fixture
def copy_of_benchmark(tmp_path, monkeypatch):
    """The benchmark's files in a fresh directory, the harness pointed there."""
    root = tmp_path / "benchmark"
    shutil.copytree(harness.BENCH, root, ignore=shutil.ignore_patterns("__pycache__"))
    monkeypatch.setattr(harness, "BENCH", root)
    return root


def test_a_new_cell_and_metric_are_found_by_name_alone(copy_of_benchmark):
    root = copy_of_benchmark
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    cell = json.loads((root / "workloads" / "beat2-stream.json").read_text())
    (root / "traffic" / "stream-b1-quarter.json").write_text(json.dumps({"utterance_s": 60.0, "chunk_samples": 4000,
                                                                         "judged_windows": 4}))
    (root / "workloads" / "beat2-stream-quarter.json").write_text(json.dumps(dict(cell, traffic="stream-b1-quarter")))
    (root / "metrics" / "pushes.stream.py").write_text("def read(s):\n    return s.get('pushes')\n")
    ctx = harness.context("beat2-stream-quarter", 1, 1.0, True, torch.device("cpu"), 0.0)
    assert ctx.traffic["chunk_samples"] == 4000 and ctx.config["mdm"]["latent_dim"] == 512
    manifest = json.loads(json.dumps(MANIFEST))
    manifest["workloads"].append({"name": "beat2-stream-quarter", "config": "beat2", "traffic": "stream-b1-quarter",
                                  "chips": 1, "why": "x"})
    manifest["end_to_end"].append({"name": "window_p95_ms", "unit": "ms", "better": "lower", "bound": 0.2,
                                   "source": "host_clock", "workloads": ["beat2-stream-quarter"]})
    manifest["per_layer"].append({"name": "pushes.stream", "unit": "1", "better": "lower", "source": "host_clock",
                                  "layer": "streaming", "moves": "window_p95_ms",
                                  "workloads": ["beat2-stream-quarter"]})
    e2e, layer = harness.cell_metrics(manifest, "beat2-stream-quarter")
    assert {m["name"] for m in e2e} == {"window_p95_ms", "setup_s"}
    assert {m["name"] for m in layer} == {"pushes.stream"}
    assert harness.read_metric("pushes.stream", {"pushes": 7}) == 7
    assert harness.read_metric("pushes.stream", {}) is None
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"


def outcome(checks, summary=None):
    return harness.Outcome(attempted=10, failed=0, e2e={"motion_s_per_s": 70.5, "setup_s": 14.2}, checks=checks,
                           memory_peak_bytes=123, summary=summary,
                           breakdown={"device_ops": [["k", 0.1]], "idle_gaps": [["host:flush", 0.01]]})


def test_result_line_schema_untraced():
    ctx = harness.context("h3d-serve-prompted", 1, 1.0, False, torch.device("cpu"), 0.0)
    line = harness.result(ctx, outcome([("latent_rel", 0.01, 0.05)]), MANIFEST,
                          {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1})
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True
    assert line["metrics"] == {"motion_s_per_s": {"value": 70.5, "unit": "motion-s/s"},
                               "setup_s": {"value": 14.2, "unit": "s"}}
    assert line["device"] == {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1, "memory_peak_bytes": 123}
    assert line["checks"] == {"latent_rel": {"value": 0.01, "limit": 0.05}}
    json.dumps(line)


def test_result_line_schema_traced():
    ctx = harness.context("h3d-serve-prompted", 1, 1.0, True, torch.device("cpu"), 0.0)
    summary = {"busy_s": 0.5, "window_s": 1.0, "span_device_s": {"sample_guided": 0.25}, "bound_s": {"k2": 0.001},
               "span_calls": {}, "span_host_s": {}}
    line = harness.result(ctx, outcome([("latent_rel", 0.01, 0.05)], summary), MANIFEST, {"platform": "gpu"})
    assert list(line)[-2:] == ["breakdown", "checks"]
    assert line["device"]["busy_s"] == 0.5 and line["device"]["window_s"] == 1.0
    assert line["metrics"]["device_idle.serve"]["value"] == pytest.approx(50.0)
    assert line["metrics"]["k2_roofline.serve"]["value"] == pytest.approx(0.4)
    assert "features_ms.serve" not in line["metrics"]  # nothing to read: left out, never 0


@pytest.mark.parametrize("checks", [[("latent_rel", 0.06, 0.05)], [("latent_rel", float("nan"), 0.05)], []])
def test_correct_needs_every_number_within_its_limit(checks):
    ctx = harness.context("h3d-serve-prompted", 1, 1.0, False, torch.device("cpu"), 0.0)
    assert harness.result(ctx, outcome(checks), MANIFEST, {"platform": "gpu"})["correct"] is False


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "syntalker_tpu_torchx", types.ModuleType("syntalker_tpu_torchx"))
    assert "syntalker_tpu_torchx" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "syntalker_tpu.models", types.ModuleType("syntalker_tpu.models"))
    assert harness.forbidden_modules() == ["syntalker_tpu.models"]
