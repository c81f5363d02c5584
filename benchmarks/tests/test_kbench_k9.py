"""The k = 9 cell at a tiny size: its column-blocked reference
(``reference/kmer_ref_blocked.py``) passes the sound run and fails the control
and each fault, and its per-layer readers read the blocked forward.

k = 9 becomes 7 here: 16,384 columns, four column blocks of the chain, the row
standardization and the Gram, over 40 transcripts long enough (6,000 bases
and more) that no column is empty.
"""

from __future__ import annotations

import time

import pytest
import torch

TINY = {"transcripts": 40, "length_median": 9000, "length_min": 6000, "k": 7}
MIX = {"warm_forwards": 1, "trace_seconds": 0.5}
LIMITS = {"r_max_abs_err": 1e-5}  # float32 against float64 at 16,384 columns
CELL = "lnc_vM25_k9.allpairs"


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to the nearest TF32 value (drop 13 mantissa bits)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def run(device=None, trace=False):
    from kbench import registry, runner

    cell = registry.resolve(CELL)
    cell.config.update(TINY)
    cell.traffic.update(MIX)
    cell.limits = LIMITS
    return runner.run_cell(cell, 2**31 + 9, 1.0, trace, device or torch.device("cpu"),
                           time.perf_counter())


def test_the_cell_uses_the_blocked_reference():
    from kbench import registry

    assert registry.resolve(CELL).config["reference"] == "reference/kmer_ref_blocked.py"


def test_sound_traced_run_is_correct_and_reads_the_chain():
    from seekr_tpu_torch.ops import normalize

    before = normalize.column_blocks["normalize"]
    res = run(trace=True)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert (normalize.column_blocks["normalize"] - before) % 4 == 0
    assert res["metrics"]["normalize_host_ms.allpairs_k9"]["value"] > 0.0


def test_control_fails(monkeypatch):
    from seekr_tpu_torch.ops import pearson

    exact = pearson.gram
    monkeypatch.setattr(pearson, "gram", lambda a, b: exact(tf32(a), tf32(b)))
    assert not run()["correct"]


def test_answer_altered_where_produced_fails(monkeypatch):
    from seekr_tpu_torch.models import pipeline

    exact = pipeline.pearson_graph

    def altered(c):
        r = exact(c)
        r[0, 1] += 1e-3
        return r

    monkeypatch.setattr(pipeline, "pearson_graph", altered)
    assert not run()["correct"]


def test_column_stats_over_half_the_batch_fails(monkeypatch):
    from seekr_tpu_torch.models import pipeline

    exact = pipeline.normalize_graph

    def half(counts, mean, std, log2_mode):
        rows = counts[: counts.shape[0] // 2].to(torch.float32)
        return exact(counts, rows.mean(dim=0), (rows - rows.mean(dim=0)).std(
            dim=0, correction=0), log2_mode)

    monkeypatch.setattr(pipeline, "normalize_graph", half)
    assert not run()["correct"]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_sound_on_the_card(monkeypatch):
    monkeypatch.delenv("SEEKR_TPU_MATMUL_PRECISION", raising=False)
    assert run(_card())["correct"]


@pytest.mark.gpu
def test_control_on_the_card_fails(monkeypatch):
    device = _card()
    monkeypatch.setenv("SEEKR_TPU_MATMUL_PRECISION", "default")
    assert not run(device)["correct"]
