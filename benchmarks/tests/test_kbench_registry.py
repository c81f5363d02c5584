"""Every cell, configuration, mix, limit and metric resolves by its name, and
``BENCHMARK.json`` keeps to the benchmark's contract."""

from __future__ import annotations

import json
import re

import pytest
from conftest import BENCH, CELLS

SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmarks/run.py"]
    assert SPEC["paths"] == ["benchmarks"]
    assert 1 <= SPEC["run_seconds"] <= 51


def test_cells_are_the_issue_cells_on_one_chip():
    assert tuple(w["name"] for w in SPEC["workloads"]) == CELLS
    assert all(w["chips"] == 1 for w in SPEC["workloads"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    from kbench import registry

    c = registry.resolve(cell)
    assert c.config["name"] == cell.split(".")[0]
    assert (BENCH / "kbench" / "drivers" / f"{c.traffic['driver']}.py").exists()
    assert (BENCH / c.config["reference"]).exists()
    assert c.limits and all(v > 0 for v in c.limits.values())
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer


def test_every_per_layer_metric_has_a_reader_that_reads_nothing_from_nothing():
    from kbench import registry

    empty = {"trace": None, "spans": {}, "counters": {}, "inputs": {}, "units_traced": 0,
             "t_window": 0.0, "peaks": registry.peaks()}
    for m in SPEC["per_layer"]:
        assert registry.metric_reader(m["name"])(empty) is None, m["name"]


def test_names_units_and_keys():
    seen = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced", "why"}),
                        ("workloads", {"name", "config", "traffic", "chips", "why"}),
                        ("end_to_end", {"name", "unit", "better", "bound", "source"}),
                        ("per_layer", {"name", "unit", "better", "source", "layer", "moves"})):
        for entry in SPEC[group]:
            assert set(entry) - {"workloads"} == keys, entry
            assert NAME.match(entry["name"]) and entry["name"] not in seen
            seen.add(entry["name"])
            if "unit" in entry:
                assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
            for text in (entry.get("why"), entry.get("layer"), entry.get("source")):
                assert text is None or (0 < len(text) <= 200 and "\n" not in text)


def test_bounds_and_sources():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", CELLS))


def test_configs_state_their_cuts():
    for c in SPEC["configs"]:
        cfg = json.loads((BENCH.parent / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"] == []
        assert cfg["assumed"] and c["file"].startswith("benchmarks/")


def test_a_full_check_fits_its_time_with_24_cells():
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
