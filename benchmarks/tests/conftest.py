"""Shared set-up of the harness's own tests: the import path and tiny cells.

Run from the root of the repository: ``python -m pytest benchmarks/tests -q``
(on the card, ``python -m pytest -m gpu benchmarks/tests -q``).  The CPU tests
drive whole runs of each cell at a tiny size with ``device="cpu"``, past the
harness's look for a card.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

CELLS = ("lnc_vM25_k6.allpairs", "lnc_vM25_k4.pval")

# each configuration's law, with fewer and shorter transcripts; k=6 becomes 3,
# since 4,096 columns over a few dozen short rows leave columns empty (NaN)
TINY_CONFIG = {"lnc_vM25_k6": {"transcripts": 48, "length_median": 250, "length_min": 60,
                               "k": 3},
               "lnc_vM25_k4": {"transcripts": 160, "length_median": 250, "length_min": 60}}
TINY_MIX = {"queries_per_call": 8, "warm_forwards": 1, "trace_seconds": 0.5}
# limits at these sizes: float32 against float64 at 64 and 256 columns, and a
# p-value granularity of one in 12,720 null values
TINY_LIMITS = {"allpairs": {"r_max_abs_err": 1e-5},
               "pval": {"pval_max_abs_err": 4e-4, "adj_pval_scaled_err": 4e-4}}


def tiny_cell(name: str):
    from kbench import registry

    cell = registry.resolve(name)
    cell.config.update(TINY_CONFIG[cell.config["name"]])
    for key, value in TINY_MIX.items():
        if key in cell.traffic:
            cell.traffic[key] = value
    cell.limits = TINY_LIMITS[cell.traffic["driver"]]
    return cell


def run_tiny(name: str, seed: int = 2**31 + 7, seconds: float = 1.0, trace: bool = False):
    import torch

    from kbench import runner

    return runner.run_cell(tiny_cell(name), seed, seconds, trace, torch.device("cpu"),
                           time.perf_counter())
