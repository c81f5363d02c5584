#!/usr/bin/env python3
"""Run one cell of the benchmark of seekr_tpu_torch once, on one CUDA card.

    python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  It makes the cell's inputs from ``--seed``,
builds and warms the program (set-up), measures for ``--seconds``, checks what
the timed path produced against the plain float64 reference in
``benchmarks/reference/``, and prints one JSON line last on standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and ``checks`` (each compared number with its
limit).  It exits non-zero with no result line where there is no CUDA card,
and where anything of JAX reached the process.
"""

from __future__ import annotations

import time

T_PROC = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from kbench import registry, runner

    cell = registry.resolve(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"kbench: {args.workload} needs {cell.chips} CUDA card(s), found {have}",
              file=sys.stderr)
        return 2
    os.environ.setdefault("USE_FLAX", "0")
    result = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda", 0), T_PROC)
    return runner.finish(result)


if __name__ == "__main__":
    sys.exit(main())
