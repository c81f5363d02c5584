"""One ``--trace 1`` run of a benchmark cell, as ``benchmarks/run.py`` makes it,
and a breakdown of the program's spans against the harness's and the device's.

For each program ``find_pval`` span in the traced slice: its length, whether
it lies inside the harness's ``find_pval`` span, the share its direct children
cover, and each child's length and the device time under it.  For
``pipeline.forward``: the host ms a forward, min, median and max.  For the
slice: the device's idle gaps, each named by the innermost program span the
host was in at the gap's middle, summed by name, and the twelve longest.

Writes the breakdown as JSON to ``out`` and one ``DETAIL {json}`` line (the
per-call list left out) to stderr; the result line on stdout is the harness's.

Run from the root of the repository on a card:
``python exp/torch_trace_breakdown.py <cell> <seed> <seconds> <out.json>``
"""

import time

T_PROC = time.perf_counter()

import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "benchmarks"), ROOT]

import torch  # noqa: E402

from kbench import arith, registry, runner  # noqa: E402
from seekr_tpu_torch.utils.profiler import dropped_spans, recorded_spans  # noqa: E402


def innermost(spans, t):
    inside = [s for s in spans if s["t0"] <= t <= s["t1"]]
    return max(inside, key=lambda s: s["t0"])["name"] if inside else "outside program spans"


def breakdown(rec: dict) -> dict:
    tr = rec["trace"]
    spans = [s for s in recorded_spans() if tr["t0"] <= s["t0"] and s["t1"] <= tr["t1"]]
    device = [(s, e) for _, s, e in tr["events"]]

    def busy_in(a, b):
        return arith.union_length([(max(s, a), min(e, b)) for s, e in device if e > a and s < b])

    out = {"spans_in_slice": len(spans), "dropped": dropped_spans(), "calls": []}
    for c in (s for s in spans if s["name"] == "find_pval"):
        outer = [(a, b) for a, b in rec["spans"].get("find_pval", [])
                 if a <= c["t0"] and c["t1"] <= b]
        kids = sorted((s for s in spans if s["parent"] == c["id"]), key=lambda s: s["t0"])
        cover = arith.union_length([(s["t0"], s["t1"]) for s in kids])
        out["calls"].append({
            "len": c["t1"] - c["t0"], "inside_harness": bool(outer),
            "harness_len": outer[0][1] - outer[0][0] if outer else None,
            "child_cover_share": cover / (c["t1"] - c["t0"]),
            "children": [[s["name"], s["t1"] - s["t0"], busy_in(s["t0"], s["t1"])]
                         for s in kids]})
    forwards = sorted(1e3 * (s["t1"] - s["t0"]) for s in spans
                      if s["name"] == "pipeline.forward")
    if forwards:
        out["forward_host_ms"] = {"n": len(forwards), "min": forwards[0],
                                  "median": forwards[len(forwards) // 2], "max": forwards[-1]}
    gaps = arith.idle_gaps(device, tr["t0"], tr["t1"])
    named = defaultdict(float)
    for a, b in gaps:
        named[innermost(spans, (a + b) / 2)] += b - a
    out["idle_by_program_span_s"] = dict(sorted(named.items(), key=lambda kv: -kv[1]))
    out["top_gaps"] = [[innermost(spans, (a + b) / 2), b - a]
                       for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:12]]
    return out


def main() -> int:
    cell_name, seed, seconds, out_path = (sys.argv[1], int(sys.argv[2]), float(sys.argv[3]),
                                          sys.argv[4])
    captured = {}
    record = runner.Context.record

    def keep(self):
        captured["rec"] = record(self)
        return captured["rec"]

    runner.Context.record = keep
    result = runner.run_cell(registry.resolve(cell_name), seed, seconds, True,
                             torch.device("cuda", 0), T_PROC)
    detail = breakdown(captured["rec"])
    with open(out_path, "w") as fh:
        json.dump(detail, fh, indent=1)
    print("DETAIL " + json.dumps({k: v for k, v in detail.items() if k != "calls"}),
          file=sys.stderr)
    return runner.finish(result)


if __name__ == "__main__":
    sys.exit(main())
