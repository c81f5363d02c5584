"""Cost of one ``seekr_tpu_torch.utils.profiler.span``, with and without a
profiler session, on this host.

Each figure is the best of 5 loops, in µs per span: an empty loop, torch's
per-thread probe alone, a span with no profiler, and, inside a
``torch.profiler`` session (CPU, plus CUDA where there is a card), a bare
``record_function`` and a span.  Prints one line, ``SPAN_COST {json}``.

Run from the root of the repository: ``python exp/torch_span_cost.py``
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch
from torch.profiler import ProfilerActivity, profile

from seekr_tpu_torch.utils.profiler import recorded_spans, reset_spans, span


def best_us(loop, n: int) -> float:
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        loop(n)
        times.append((time.perf_counter() - t0) / n * 1e6)
    return min(times)


def empty(n):
    for _ in range(n):
        pass


def probe(n):
    enabled = torch.autograd._profiler_enabled
    for _ in range(n):
        enabled()


def spans(n):
    for _ in range(n):
        with span("x"):
            pass


def record_functions(n):
    for _ in range(n):
        with torch.profiler.record_function("x"):
            pass


def main() -> None:
    out = {"empty_us": best_us(empty, 200_000), "probe_us": best_us(probe, 200_000),
           "span_off_us": best_us(spans, 200_000)}
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    reset_spans()
    with profile(activities=activities):
        out["record_function_on_us"] = best_us(record_functions, 2_000)
        out["span_on_us"] = best_us(spans, 2_000)
    out["recorded"] = len(recorded_spans())
    reset_spans()
    print("SPAN_COST " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
