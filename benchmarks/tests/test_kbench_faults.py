"""The check fails what it must: the control and each fault a cell can have.

Each test drives a whole tiny run on the CPU, past the look for a card, with
the timed path broken underneath, and sees ``correct`` come out false; the
sound run beside it comes out true.  The control is the program's Pearson
product with its operands rounded to TF32 (10 mantissa bits), the precision
below the float32 every configuration states: on the card it is the
program's own ``SEEKR_TPU_MATMUL_PRECISION=default`` (``test_kbench_card``).
"""

from __future__ import annotations

import pytest
import torch
from conftest import CELLS, run_tiny


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to the nearest TF32 value (drop 13 mantissa bits)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = run_tiny(cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell, monkeypatch):
    from seekr_tpu_torch.ops import pearson

    exact = pearson.gram
    monkeypatch.setattr(pearson, "gram", lambda a, b: exact(tf32(a), tf32(b)))
    assert not run_tiny(cell)["correct"]


def _alter_r(monkeypatch):
    from seekr_tpu_torch.models import pipeline

    exact = pipeline.pearson_graph

    def altered(c):
        r = exact(c)
        r[0, 1] += 1e-3
        return r

    monkeypatch.setattr(pipeline, "pearson_graph", altered)


def _alter_pvals(monkeypatch):
    import importlib

    find_pval = importlib.import_module("seekr_tpu_torch.stats.find_pval")
    exact = find_pval._empirical_pval_fn

    def altered(fitres):
        fn = exact(fitres)

        def pvals(sim):
            p = fn(sim)
            p.flat[0] += 0.01
            return p
        return pvals

    monkeypatch.setattr(find_pval, "_empirical_pval_fn", altered)


ALTER = {"lnc_vM25_k6.allpairs": _alter_r, "lnc_vM25_k4.pval": _alter_pvals}


@pytest.mark.parametrize("cell", CELLS)
def test_answer_altered_where_produced_fails(cell, monkeypatch):
    ALTER[cell](monkeypatch)
    assert not run_tiny(cell)["correct"]


def test_column_stats_over_half_the_batch_fails(monkeypatch):
    """The normalize chain's column mean and std taken over half the rows."""
    from seekr_tpu_torch.models import pipeline

    exact = pipeline.normalize_graph

    def half(counts, mean, std, log2_mode):
        rows = counts[: counts.shape[0] // 2].to(torch.float32)
        if mean is None:
            mean = rows.mean(dim=0)
        if std is None:
            std = (rows - mean).std(dim=0, correction=0)
        return exact(counts, mean, std, log2_mode)

    monkeypatch.setattr(pipeline, "normalize_graph", half)
    assert not run_tiny("lnc_vM25_k6.allpairs")["correct"]
