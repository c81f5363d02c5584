"""Nothing of JAX reaches the harness, and the reference takes nothing of the
program; without a card, or without the program, a run prints no result."""

from __future__ import annotations

import ast
import shutil
import subprocess
import sys

from conftest import BENCH
from kbench.guard import forbidden_modules

PROGRAM = "seekr_tpu_torch"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_no_file_of_the_harness_imports_jax_or_the_jax_package():
    files = list(BENCH.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        assert not {"jax", "jaxlib", "flax", "seekr_tpu"} & set(_imports(path)), path


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert set(_imports(path)) <= {"__future__", "torch", "numpy", "math"}, path


def test_the_guard_compares_whole_top_level_names():
    assert forbidden_modules({"seekr_tpu_torch": 0, "seekr_tpu_torch.serve": 0}) == []
    assert forbidden_modules({"seekr_tpu.ops": 0, "jaxlib.xla": 0}) == ["jaxlib", "seekr_tpu"]


def _run(cwd, *extra):
    return subprocess.run([sys.executable, "benchmarks/run.py", "--workload",
                           "lnc_vM25_k6.allpairs", "--seed", "1", "--seconds", "1",
                           "--trace", "0", *extra], cwd=cwd, capture_output=True,
                          text=True, timeout=300)


def test_without_a_card_no_result(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    res = _run(BENCH.parent)
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_with_only_the_benchmark_no_result(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _run(tmp_path)
    assert res.returncode != 0 and res.stdout.strip() == ""
