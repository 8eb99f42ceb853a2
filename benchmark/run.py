"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is ``benchmark/workloads/<name>.json``: its configuration
(``benchmark/configs/<config>.json``), its traffic
(``benchmark/traffic/<traffic>.json``), the driver that serves that traffic
(``benchmark/drivers/<driver>.py``) and the host threads it runs with.
Which metrics the cell reports comes from ``BENCHMARK.json`` beside the
benchmark; each per-layer metric is read by ``benchmark/metrics/<name>.py``.
The last line of standard output is one JSON object; the numbers that
decided ``correct`` end standard error, each beside its limit.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
CHECKOUT = BENCH.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    cell = json.loads((BENCH / "workloads" / f"{args.workload}.json").read_text())
    threads = str(cell["host_threads"])
    # before numpy and torch load: their thread pools read these once
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = threads
    build = CHECKOUT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    # the checkout, not this directory, is where imports start: the benchmark is the package ``benchmark``
    sys.path[:] = [str(CHECKOUT)] + [q for q in sys.path if Path(q or ".").resolve() != BENCH]

    from benchmark import harness

    return harness.run_cell(args, cell, T_START)


if __name__ == "__main__":
    sys.exit(main())
