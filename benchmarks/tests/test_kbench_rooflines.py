"""Operations and bytes of the kernels at the cells' sizes."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from kbench import corpus, registry


def test_gram_at_13000_rows_of_4096():
    flops, nbytes = registry.roofline("gram").work({"m": 13000, "k": 6})
    assert flops == 2 * 13000**2 * 4096 == 1_384_448_000_000
    assert nbytes == 4 * (13000 * 4096 + 13000**2) == 888_992_000
    peaks = registry.peaks()
    bound = max(flops / peaks["tf32_flops_per_s"], nbytes / peaks["hbm_bytes_per_s"])
    assert bound == pytest.approx(2.7986e-3, rel=1e-4)  # operations bound it


def test_count_bytes_model():
    mod = registry.roofline("count_kmers_smem")
    lengths = np.array([200, 4096, 5, 6])  # a short row counts no window
    flops, nbytes = mod.work({"lengths": lengths, "lpad": 4096, "k": 6})
    assert flops == 0
    assert nbytes == (200 + 4096 + 0 + 6) + 4 * 4 + 4 * 4 * 4096


def test_count_bytes_of_the_corpus():
    """The 13,000-row corpus: every seed has the same lengths, none cut from above."""
    cfg = registry.resolve("lnc_vM25_k6.allpairs").config
    lengths = corpus.stratified_lengths(cfg["transcripts"], cfg, "cpu").numpy()
    assert lengths.min() == 200 and lengths.max() == 15010
    assert 1350 <= np.median(lengths) <= 1450 and int(lengths.sum()) == 21_782_225
    _, nbytes = registry.roofline("count_kmers_smem").work(
        {"lengths": lengths, "lpad": int(lengths.max()), "k": 6})
    assert nbytes == int(lengths.sum()) + 4 * 13000 + 4 * 13000 * 4096 == 234_826_225
    assert nbytes / registry.peaks()["hbm_bytes_per_s"] == pytest.approx(7.0e-5, rel=0.05)


def test_corpus_law_and_seed():
    cfg = registry.resolve("lnc_vM25_k6.allpairs").config
    b1, n1 = corpus.make_corpus(500, cfg, corpus.generator("cpu", 2**31 + 5, 0))
    b2, n2 = corpus.make_corpus(500, cfg, corpus.generator("cpu", 2**31 + 5, 0))
    b3, n3 = corpus.make_corpus(500, cfg, corpus.generator("cpu", 2**33 + 1, 0))
    assert torch.equal(b1, b2) and torch.equal(n1, n2)
    assert not torch.equal(b1, b3) and torch.equal(n1.sort().values, n3.sort().values)
    inside = torch.arange(b1.shape[1])[None, :] < n1[:, None]
    share_n = (b1[inside] == 4).float().mean().item()
    assert 1e-4 < share_n < 2e-3 and bool((b1[~inside] == 4).all())
