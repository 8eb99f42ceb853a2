"""Readings that a cell's limits are set from: the program's judged numbers
and the control's (``benchmark/control.py``) on the same items, seed after
seed in one process, each run with a short window.

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 --seconds 4 [--traffic key=value ...] [--fault name]

One JSON line a seed. ``--traffic`` overrides a traffic parameter for these
readings; the judged items and their sizes stay the cell's.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--traffic", nargs="*", default=[])
    p.add_argument("--device", default="cuda")
    p.add_argument("--fault", default=None, help="a fault of benchmark/faults.py planted in the program")
    args = p.parse_args()
    sys.path[:] = [str(CHECKOUT)] + [q for q in sys.path if Path(q or ".").resolve() != CHECKOUT / "benchmark"]
    import torch

    from benchmark import faults, harness

    if args.fault:
        faults.FAULTS[args.fault](faults.patcher()[0])
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = harness.context(args.workload, seed, args.seconds, False, torch.device(args.device), time.perf_counter())
        for kv in args.traffic:
            k, v = kv.split("=", 1)
            ctx.traffic[k] = json.loads(v)
        out = harness.drive(ctx, with_control=True)
        print(json.dumps({"workload": args.workload, "seed": seed, "fault": args.fault, "attempted": out.attempted,
                          "program": {n: v for n, v, _ in out.checks}, "control": out.control,
                          "e2e": out.e2e, "notes": out.notes}), flush=True)
        del out
        gc.collect()
        if args.device == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
