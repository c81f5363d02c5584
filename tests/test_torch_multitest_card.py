"""Benjamini-Hochberg on a card (``stats.multitest._fdr_torch``'s route).

Every test here needs a CUDA card and skips without one; this file imports no
jax, so it runs on the card's machine with ``--noconftest``.  ``adj_pval`` and
``multipletests`` with no ``device`` take the card there: their output must be
bitwise ``device="cpu"``'s (the host's C++ library and numpy), and
``fdr_routes["device"]`` must advance by one a call.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from seekr_tpu_torch.io.fast_csv import LabeledMatrix
from seekr_tpu_torch.ops.ecdf import DeviceSortedBackground
from seekr_tpu_torch.stats import adj_pval, multitest
from seekr_tpu_torch.stats.multitest import multipletests


def need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def ecdf_p(rows, cols, device, seed, symmetric=False):
    """float32 p of an r-like [rows, cols] against a 2 M-value null, on the card
    as find_pval makes them (many ties: p is a count over the null's size)."""
    g = torch.Generator(device=device).manual_seed(seed)
    null = torch.randn(2_000_000, generator=g, device=device) * 0.1
    r = torch.randn(rows, cols, generator=g, device=device) * 0.12
    if symmetric:
        r = (r + r.T) / 2  # bitwise symmetric: the sum commutes
    return DeviceSortedBackground(null.cpu().numpy(), device).pvals(r)


def routed_and_host(p, labels, cols, method="fdr_bh"):
    before = multitest.fdr_routes["device"]
    on_card = adj_pval(LabeledMatrix(p, labels, cols), method).values
    assert multitest.fdr_routes["device"] == before + 1
    on_host = adj_pval(LabeledMatrix(p, labels, cols), method, device="cpu").values
    assert multitest.fdr_routes["device"] == before + 1
    return on_card, on_host


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["fdr_bh", "fdr_by"])
def test_gpu_adj_pval_at_the_pval_cell_shape(method):
    device = need_cuda()
    p = ecdf_p(500, 13_000, device, seed=1)
    assert p.dtype == np.float32
    on_card, on_host = routed_and_host(p, [f"q{i}" for i in range(500)],
                                       [f"t{j}" for j in range(13_000)], method)
    assert on_card.tobytes() == on_host.tobytes()


@pytest.mark.gpu
def test_gpu_adj_pval_on_a_symmetric_matrix(capsys):
    device = need_cuda()
    p = ecdf_p(2048, 2048, device, seed=2, symmetric=True)
    labels = [f"r{i}" for i in range(2048)]
    on_card, on_host = routed_and_host(p, labels, labels)
    assert "is a symmetric matrix" in capsys.readouterr().out
    assert on_card.tobytes() == on_host.tobytes()


@pytest.mark.gpu
def test_gpu_multipletests_equals_numpy_and_native(monkeypatch):
    device = need_cuda()
    p = ecdf_p(500, 13_000, device, seed=3).ravel()
    on_card = multipletests(p)[:2]
    for mode in ("native", "numpy"):
        monkeypatch.setenv("SEEKR_TPU_HOST_SORT", mode)
        on_host = multipletests(p, device="cpu")[:2]
        assert on_card[1].tobytes() == on_host[1].tobytes()
        assert np.array_equal(on_card[0], on_host[0])


@pytest.mark.gpu
def test_gpu_workflow_triangle_size():
    # the workflow's 13,000-row upper triangle: 84.5 M values, float64
    device = need_cuda()
    rng = np.random.default_rng(4)
    p = np.floor(rng.random(84_493_500) ** 2 * 84_493_500) / 84_493_500
    before = multitest.fdr_routes["device"]
    on_card = multipletests(p)[1]
    assert multitest.fdr_routes["device"] == before + 1
    assert on_card.tobytes() == multipletests(p, device="cpu")[1].tobytes()
    del on_card
    torch.cuda.synchronize(device)


@pytest.mark.gpu
def test_gpu_nan_signed_zero_and_infinities():
    device = need_cuda()
    p = ecdf_p(300, 1000, device, seed=5).astype(np.float64).ravel()
    p[[3, 30]] = -0.0
    p[[4, 40]] = (np.inf, -np.inf)
    before = dict(multitest.fdr_routes)
    assert multipletests(p)[1].tobytes() == multipletests(p, device="cpu")[1].tobytes()
    p[77] = np.nan  # the card leaves NaN to the host
    got = multipletests(p)[1]
    assert got.tobytes() == multipletests(p, device="cpu")[1].tobytes()
    assert np.isnan(got).all()
    assert multitest.fdr_routes["device"] == before["device"] + 1
