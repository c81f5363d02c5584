"""The empirical p-values of the benchmark's pval cell, on the host and on the
card: ``SortedBackground`` against ``DeviceSortedBackground``.

A null of 84,493,500 float32 values (the pairs of 13,000 transcripts, every
97th NaN, a run of repeats) and r of [500, 13,000] float32 (a tenth of them
exact ties with the null), drawn from ``--seed``.  The host path is timed once
(its sort, its search); the device path ``--reps`` times, each part ending in a
synchronize: the copy of the null to the card, its NaN filter and sort, and
``pvals`` (r's copy to the card, the search, the divide and p's copy back).
The two results must be bitwise equal.  Prints one line, ``ECDF_DEVICE {json}``.

Run from the root of the repository on a card:
``python exp/torch_ecdf_device.py [--seed N] [--reps N]``
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from seekr_tpu_torch.ops.ecdf import DeviceSortedBackground, SortedBackground

NULL_VALUES = 13_000 * 12_999 // 2
QUERY_ROWS, TARGETS = 500, 13_000


def case(seed: int):
    rng = np.random.default_rng(seed)
    null = (rng.standard_normal(NULL_VALUES, dtype=np.float32) * np.float32(0.08))
    null[::97] = np.nan
    null[1:100_000:2] = null[0]
    r = rng.standard_normal((QUERY_ROWS, TARGETS), dtype=np.float32) * np.float32(0.08)
    tie = rng.random(r.shape) < 0.1
    r[tie] = null[rng.integers(0, NULL_VALUES, int(tie.sum()))]
    return null, r


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    device = torch.device("cuda", 0)
    null, r = case(args.seed)
    out = {"null_values": NULL_VALUES, "cells": int(r.size)}

    t0 = time.perf_counter()
    host = SortedBackground(null)
    t1 = time.perf_counter()
    want = host.pvals(r).astype(np.float32)
    t2 = time.perf_counter()
    out["host_sort_s"], out["host_search_s"] = t1 - t0, t2 - t1
    del host

    parts = {"device_sort_s": [], "device_pvals_s": [], "device_total_s": []}
    got = None
    for _ in range(args.reps + 1):  # the first warms torch.sort and searchsorted
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dev = DeviceSortedBackground(null, device)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got = dev.pvals(torch.as_tensor(r))
        t2 = time.perf_counter()
        del dev
        for name, value in (("device_sort_s", t1 - t0), ("device_pvals_s", t2 - t1),
                            ("device_total_s", t2 - t0)):
            parts[name].append(value)
    for name, values in parts.items():
        out[name] = statistics.median(values[1:])
        out[name[:-2] + "_first_s"] = values[0]
    out["bitwise_equal"] = got.tobytes() == want.tobytes()
    out["peak_device_bytes"] = torch.cuda.max_memory_allocated(device)
    print("ECDF_DEVICE " + json.dumps(out), flush=True)
    if not out["bitwise_equal"]:
        raise SystemExit("the device p-values differ from the host's")


if __name__ == "__main__":
    main()
