"""BENCHMARK.json against the benchmark's own files and the manifest's rules:
names, units, keys, the files each entry names, and what each cell reports."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys_and_command():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "benchmark/run.py"]
    assert MANIFEST["paths"] == ["benchmark"]
    assert 1 <= MANIFEST["run_seconds"] <= 51 and isinstance(MANIFEST["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entry_keys_and_names(section):
    entries = MANIFEST[section]
    assert entries
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]


def test_configs_name_their_files():
    for c in MANIFEST["configs"]:
        f = ROOT / c["file"]
        assert f.is_file() and c["file"].startswith("benchmark/")
        data = json.loads(f.read_text())
        assert data["reduced"] == c["reduced"]
        for key in c["reduced"]:  # a departure from the source, never a width
            assert key in data or key in data["mdm"], key
            assert not key.endswith(("_dim", "_rank", "_size", "_width")) and key not in ("width", "nb_code"), key
        assert (BENCH / "configs" / f"{c['name']}.json") == f
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}


def test_cells_match_their_files():
    pairs = set()
    for w in MANIFEST["workloads"]:
        cell = json.loads((BENCH / "workloads" / f"{w['name']}.json").read_text())
        assert (cell["config"], cell["traffic"], cell["chips"], cell["why"]) == (
            w["config"], w["traffic"], w["chips"], w["why"])
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "drivers" / f"{cell['driver']}.py").is_file()
        assert w["chips"] == 1
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert cell["limits"]


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    from benchmark.harness import cell_metrics

    for w in MANIFEST["workloads"]:
        e2e, layer = cell_metrics(MANIFEST, w["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2
        assert layer


def test_metrics_sources_bounds_and_readers():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        cells = m.get("workloads", [])
        for cell in cells:
            assert cell in e2e[m["moves"]].get("workloads", [cell])


def test_run_seconds_fit_a_full_check_of_24_cells():
    rs = MANIFEST["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_layers_share_their_names():
    layers = {}
    for m in MANIFEST["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
