"""The readers of the program's spans: a tiny traced run of each cell gives
every one of them a number, and a run without a trace gives none."""

from __future__ import annotations

import json

import pytest
from conftest import BENCH, CELLS, run_tiny

SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
SPAN_METRICS = {cell: [m["name"] for m in SPEC["per_layer"]
                       if m["source"] == "program_span" and cell in m["workloads"]]
                for cell in CELLS}


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_gives_every_span_metric_a_number(cell):
    assert SPAN_METRICS[cell]
    res = run_tiny(cell, trace=True)
    assert res["correct"], res["checks"]
    for name in SPAN_METRICS[cell]:
        value = res["metrics"][name]["value"]
        assert isinstance(value, float) and value > 0.0, (name, value)
    if cell == "lnc_vM25_k4.pval":
        # the program's stages lie inside the harness's span around the call
        stages = sum(res["metrics"][name]["value"] for name in
                     ("find_pval_self_s.pval", "fasta_encode_s.pval", "ecdf_sort_s.pval",
                      "ecdf_search_s.pval"))
        assert stages < res["metrics"]["find_pval_s.pval"]["value"]


def test_a_record_without_a_trace_reads_nothing():
    from kbench import program_spans

    assert program_spans.in_slice({"trace": None}) is None
    assert program_spans.calls({"trace": {"t0": 0.0, "t1": 0.0}}, "find_pval") is None
