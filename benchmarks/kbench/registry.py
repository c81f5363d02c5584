"""Find everything a cell needs by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
Each is a data file found by name:

    configs/<config file>            sizes of the deployment (named in ``configs``)
    traffic/<traffic>.json           parameters of the mix; ``driver`` names the
                                     general generator in ``kbench/drivers/``
    limits/<cell>.json               the limit of each number the check compares
    metrics/<metric>.py              the reader of one per-layer metric; a name
                                     ``a.b`` falls back to ``metrics/a.py``
    rooflines/<kernel>.py            a kernel's operations, bytes and trace name
    <config's reference>             the plain reference beside the configuration

Nothing here knows a cell, a mix or a metric by name.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
REPO_DIR = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: Path, name: str):
    """Import one file of the yardstick by its path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def benchmark(root: Path = REPO_DIR) -> dict:
    return load_json(root / "BENCHMARK.json")


def resolve(cell_name: str, root: Path = REPO_DIR) -> Cell:
    """The cell ``cell_name`` with its configuration, mix, limits and metrics."""
    spec = benchmark(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no workload {cell_name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[cell_name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    limits = load_json(BENCH_DIR / "limits" / f"{cell_name}.json")
    e2e = [m for m in spec["end_to_end"] if _applies(m, cell_name)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if _applies(m, cell_name) and m["moves"] in reported]
    return Cell(cell_name, int(w["chips"]), config, traffic, limits, e2e, layer)


def metric_reader(name: str):
    """The ``read(record)`` function of a per-layer metric."""
    for stem in (name, name.split(".", 1)[0]):
        path = BENCH_DIR / "metrics" / f"{stem}.py"
        if path.exists():
            return load_module(path, f"kbench_metric_{stem}").read
    raise FileNotFoundError(f"no reader metrics/{name}.py or metrics/"
                            f"{name.split('.', 1)[0]}.py")


def roofline(kernel: str):
    """The module of ``rooflines/<kernel>.py``: ``KERNEL`` (a regular expression
    over trace names) and ``work(inputs) -> (flops, bytes)``."""
    return load_module(BENCH_DIR / "rooflines" / f"{kernel}.py", f"kbench_roofline_{kernel}")


def driver(name: str):
    return load_module(BENCH_DIR / "kbench" / "drivers" / f"{name}.py", f"kbench_driver_{name}")


def peaks() -> dict:
    return load_json(BENCH_DIR / "peaks.json")


def reference(config: dict):
    """The plain reference a configuration names (its ``reference`` key)."""
    return load_module(BENCH_DIR / config["reference"], "kbench_reference_" + config["name"])
