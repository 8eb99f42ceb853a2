"""What every cell shares: the run's context, the checks on the machine, the
per-layer metric readers, and the result line."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Optional

BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "syntalker_tpu")


@dataclasses.dataclass
class Ctx:
    """One run of one cell."""

    name: str
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object  # torch.device
    t_start: float  # perf_counter at process start
    marks: list = dataclasses.field(default_factory=list)  # (step of set-up, perf_counter at its end)

    def mark(self, step: str) -> None:
        self.marks.append((step, time.perf_counter()))

    def setup_steps(self) -> dict:
        """Seconds of each marked step of set-up."""
        out, prev = {}, self.t_start
        for step, t in self.marks:
            out[step] = t - prev
            prev = t
        return out


@dataclasses.dataclass
class Outcome:
    """What a driver hands back once its window has closed."""

    attempted: int
    failed: int
    e2e: dict  # end-to-end metric name -> value
    checks: list  # (name, value, limit): correct when every value <= its limit
    memory_peak_bytes: int
    summary: Optional[dict] = None  # the traced window, read by the per-layer metrics
    breakdown: Optional[dict] = None
    control: Optional[dict] = None  # the control's numbers on the same items, where asked for
    notes: Optional[dict] = None  # more readings of the window, printed on standard error


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def context(name: str, seed: int, seconds: float, trace: bool, device, t_start: float) -> Ctx:
    cell = load_json(BENCH / "workloads" / f"{name}.json")
    return Ctx(name, cell, load_json(BENCH / "configs" / f"{cell['config']}.json"),
               load_json(BENCH / "traffic" / f"{cell['traffic']}.json"), seed, seconds, trace, device, t_start)


def cell_metrics(manifest: dict, name: str):
    """The end-to-end and per-layer metrics that ``BENCHMARK.json`` has this
    cell report."""
    e2e = [m for m in manifest["end_to_end"] if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, layer


def read_metric(name: str, summary: dict):
    """The per-layer metric ``name`` from ``benchmark/metrics/<name>.py``;
    None where its reader finds nothing to read."""
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}",
                                                  BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(summary)


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def drive(ctx: Ctx, with_control: bool = False) -> Outcome:
    driver = importlib.import_module(f"benchmark.drivers.{ctx.cell['driver']}")
    return driver.run(ctx, with_control)


def result(ctx: Ctx, out: Outcome, manifest: dict, device_info: dict) -> dict:
    """The result line: end-to-end metrics without a trace, per-layer with."""
    e2e, layer = cell_metrics(manifest, ctx.name)
    metrics = {}
    if ctx.trace:
        for m in layer:
            v = read_metric(m["name"], out.summary or {})
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in e2e:
            metrics[m["name"]] = {"value": out.e2e[m["name"]], "unit": m["unit"]}
    correct = bool(out.checks) and out.failed == 0 and all(
        math.isfinite(v) and v <= limit for _, v, limit in out.checks)
    line = {"correct": correct, "attempted": out.attempted, "failed": out.failed, "metrics": metrics,
            "device": dict(device_info, memory_peak_bytes=out.memory_peak_bytes)}
    if ctx.trace and out.summary:
        line["device"].update(busy_s=out.summary["busy_s"], window_s=out.summary["window_s"])
        if out.breakdown:
            line["breakdown"] = out.breakdown
    line["checks"] = {n: {"value": v, "limit": limit} for n, v, limit in out.checks}
    return line


def run_cell(args, cell: dict, t_start: float) -> int:
    import torch

    t_torch = time.perf_counter()
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell needs {chips} CUDA device(s), this machine has {n}", file=sys.stderr)
        return 2
    torch.set_num_threads(int(cell["host_threads"]))
    ctx = context(args.workload, args.seed, args.seconds, bool(args.trace), torch.device("cuda"), t_start)
    ctx.marks.append(("import torch", t_torch))
    torch.zeros(1, device=ctx.device)
    ctx.mark("CUDA context")
    manifest = load_json(BENCH.parent / "BENCHMARK.json")
    out = drive(ctx)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}
    line = result(ctx, out, manifest, info)
    print("set-up, s: " + json.dumps(ctx.setup_steps()), file=sys.stderr)
    if out.notes:
        print("window: " + json.dumps(out.notes), file=sys.stderr)
    for n, c in line["checks"].items():
        print(f"check {n}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0

