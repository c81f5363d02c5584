#!/usr/bin/env python3
"""The readings that the limits of ``limits/<cell>.json`` are set from.

    python3 benchmarks/readings.py --workload <cell> --seeds 11,12,13 --seconds 3 [--control]

Runs the cell once per seed in this one process (a short window at the cell's
own load and sizes, then the check) and prints one JSON line per seed with
each compared number.  ``--control`` runs the program with its own TF32 path
switched on (``SEEKR_TPU_MATMUL_PRECISION=default``): float32 with TF32 off is
what every configuration states, TF32 the next precision below.  The sound
runs give each number's lower reading (the largest over a dozen seeds or
more), the control its upper one (the smallest over three or more).
"""

from __future__ import annotations

import time

T_PROC = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from kbench import registry, runner

    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    if args.control:
        os.environ["SEEKR_TPU_MATMUL_PRECISION"] = "default"
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = registry.resolve(args.workload)
        res = runner.run_cell(cell, seed, args.seconds, False, torch.device("cuda", 0),
                              time.perf_counter())
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "mode": "control" if args.control else "program",
                          "correct": res["correct"], "attempted": res["attempted"],
                          "failed": res["failed"],
                          "checks": {k: v["value"] for k, v in res["checks"].items()}}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
