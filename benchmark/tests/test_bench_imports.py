"""What the benchmark loads: no JAX and no JAX package in a run, and a
reference that takes nothing from the program. Top-level module names are
compared whole: the port's name begins with the JAX package's."""

import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "syntalker_tpu"}

RUN = """
import json, sys
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
import tiny
from benchmark import harness
for name in ("beat2-stream", "h3d-serve-prompted"):
    harness.drive(tiny.ctx(name))
print(json.dumps(sorted(sys.modules)))
"""


def loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT, timeout=900,
                         env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "2", "HOME": str(ROOT)})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_of_each_driver_loads_no_jax():
    mods = loaded(RUN.format(root=str(ROOT), tests=str(ROOT / "benchmark" / "tests")))
    assert "syntalker_tpu_torch" in mods and "benchmark.drivers.serve" in mods
    assert not {m for m in mods if m.split(".")[0] in FORBIDDEN}


def test_the_reference_loads_nothing_of_the_program():
    code = ("import json, sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.model, benchmark.reference.audio\n"
            "print(json.dumps(sorted(sys.modules)))" % str(ROOT))
    mods = loaded(code)
    assert "benchmark.reference.decode" in mods
    assert not {m for m in mods if m.split(".")[0] in FORBIDDEN | {"syntalker_tpu_torch"}}


def test_the_reference_sources_import_only_torch_numpy_scipy_and_themselves():
    allowed = {"torch", "numpy", "scipy", "benchmark", "__future__", "math", "dataclasses", "itertools", "contextlib",
               "typing"}
    for f in (ROOT / "benchmark" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] in allowed, (f.name, n)
                assert not n.startswith("benchmark.") or n.startswith("benchmark.reference"), (f.name, n)
