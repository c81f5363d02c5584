"""The symmetric split-TF32 GEMM's plan and plain twin (``ops/sym_gemm_cuda.py``) on the CPU.

The kernel (``csrc/sym_gemm.cu``) runs only on a card (``test_torch_sym_gemm_card.py``);
here its tile plan is held to the upper triangle, and the twin, which any CPU
tensor takes, to float64 and to seekr_tpu's Pearson: exactly symmetric, NaN rows
and columns where float64 has them, and no launch counted in ``ops.pearson.sym_gemm``.
"""

from __future__ import annotations

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seekr_tpu.ops import pearson as jax_ops
from seekr_tpu_torch.ops import pearson as P
from seekr_tpu_torch.ops import sym_gemm_cuda as S


def operand(m, n, seed, nan_rows=()):
    """Row-standardized gamma counts, [m, n] float32, with NaN rows where asked."""
    rng = np.random.default_rng(seed)
    a = P.standardize_rows(rng.gamma(2.0, 1.0, size=(m, n)).astype(np.float32), device="cpu")
    for row in nan_rows:
        a[row] = float("nan")
    return a


def float64_r(a):
    a64 = a.double()
    return (a64 @ a64.T) / a.shape[1]


def bitwise_symmetric(r):
    bits = r.view(torch.int32)
    return torch.equal(bits, bits.T)


@pytest.mark.parametrize("m", [1, 127, 128, 129, 13_000])
def test_tile_plan_covers_the_upper_triangle_once(m):
    plan = S.tile_plan(m)
    t = -(-m // S.TILE)
    assert plan.dtype == np.int32 and plan.shape == (S.tiles_of(m), 2)
    assert len(plan) == t * (t + 1) // 2
    seen = np.zeros((t, t), dtype=np.int64)
    np.add.at(seen, (plan[:, 0], plan[:, 1]), 1)
    assert (np.triu(seen) == 1)[np.triu_indices(t)].all()
    assert not np.tril(seen, -1).any()
    # every element (i, j) with i <= j < m lies in one planned tile: its own
    i, j = np.triu_indices(min(m, 300))
    assert (seen[i // S.TILE, j // S.TILE] == 1).all()
    # bands of GROUP tile rows, in order
    assert (np.diff(plan[:, 0] // S.GROUP) >= 0).all()


def test_tile_plan_of_no_rows_is_empty():
    assert S.tile_plan(0).shape == (0, 2) and S.tiles_of(0) == 0


@pytest.mark.parametrize("m, n, nan_rows", [(200, 4096, ()), (150, 2 * 4096, ()),
                                            (129, 1000, ()), (129, 4096 + 96, (3, 64))])
def test_twin_matches_float64(m, n, nan_rows):
    # one block, two blocks, a row count that is no multiple of the tile, a narrow
    # last block and NaN rows
    a = operand(m, n, seed=m + n, nan_rows=nan_rows)
    got = P.split_gram(a, n=n)
    want = float64_r(a)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    for row in nan_rows:
        assert torch.isnan(got[row]).all() and torch.isnan(got[:, row]).all()
    assert (got.double() - want)[~nan].abs().max().item() <= 1e-6


@pytest.mark.parametrize("m, n, nan_rows", [(130, 4096, ()), (77, 3 * 4096 + 5, (10,))])
def test_twin_is_exactly_symmetric(m, n, nan_rows):
    got = P.split_gram(operand(m, n, seed=m, nan_rows=nan_rows), n=n)
    assert bitwise_symmetric(got)


@pytest.mark.parametrize("n", [4096, 2 * 4096])
def test_fused_route_with_twins_is_seekr_tpus_pearson(n):
    # the card's route end to end in its twins: float64 row moments, the split,
    # the symmetric GEMM
    from seekr_tpu_torch.ops import epilogue_cuda as E

    rng = np.random.default_rng(n)
    raw = rng.gamma(2.0, 1.0, size=(40, n)).astype(np.float32)
    got = P.fused_pearson(torch.from_numpy(raw), E.row_moments_plain, E.standardize_split_plain)
    assert bitwise_symmetric(got)
    want = np.asarray(jax_ops.pearson_graph(jnp.asarray(raw)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_twin_adds_to_earlier_blocks_and_divides_last():
    # first: r holds nothing yet; a later block adds its sum; the last divides and mirrors
    a = operand(60, 256, seed=9)
    hi, lo = P.split_tf32(a)
    out = torch.full((60, 60), float("nan"))
    S.sym_split_gemm(hi, lo, out, first=True, last=False, n=512)
    once = out.clone()
    S.sym_split_gemm(hi, lo, out, first=False, last=True, n=512)
    upper = torch.ones((60, 60), dtype=torch.bool).triu_()
    want = torch.where(upper, once + once, (once + once).T) / torch.tensor(512.0)
    assert torch.equal(out, want)
    assert (out.double() - float64_r(torch.cat([a, a], dim=1))).abs().max().item() <= 1e-6


@pytest.mark.parametrize("n_cols", [4096, 3 * 4096 + 5])
def test_split_gram_on_the_cpu_counts_its_blocks_and_no_launch(n_cols):
    # the twin launches nothing, so the kernel's counters stay where they were
    # (the card's launches and tiles: test_torch_sym_gemm_card.py)
    a = operand(140, n_cols, seed=n_cols)
    blocks = len(P.blocks_of(n_cols))
    before = dict(P.sym_gemm), P.column_blocks["gram"]
    P.split_gram(a, n=n_cols)
    assert P.sym_gemm is S.counts
    assert P.sym_gemm == before[0]
    assert S.tiles_of(140) == 3 == len(S.tile_plan(140))  # (0, 0), (0, 1), (1, 1)
    assert P.column_blocks["gram"] == before[1] + blocks


@pytest.mark.parametrize("value", ["high", "highest", "default"])
def test_cpu_pearson_graph_takes_no_symmetric_gemm(monkeypatch, value):
    # a CPU tensor has no TF32: every setting takes the plain product, as before
    monkeypatch.setenv("SEEKR_TPU_MATMUL_PRECISION", value)
    rng = np.random.default_rng(4)
    c = torch.from_numpy(rng.gamma(2.0, 1.0, size=(30, 1024)).astype(np.float32))
    before = dict(P.sym_gemm)
    P.pearson_graph(c)
    assert P.sym_gemm == before


def test_cpu_self_gram_is_the_float32_product_divided():
    a = operand(20, 512, seed=2)
    assert torch.equal(P.self_gram(a, 512), P.divide(P.gram(a, a), 512))


def test_launcher_takes_the_twin_for_cpu_tensors_and_checks_cuda_inputs():
    a = operand(50, 300, seed=6)
    hi, lo = P.split_tf32(a)
    before = dict(S.counts)
    got = S.sym_split_gemm(hi, lo, torch.empty(50, 50), True, True, 300)
    want = S.sym_split_gemm_plain(hi, lo, torch.empty(50, 50), True, True, 300)
    assert torch.equal(got, want)
    assert S.counts == before
    with pytest.raises(ValueError):  # the kernel's checks refuse what is not on a card
        S._check(hi, lo, torch.empty(50, 50))


def test_the_twins_fold_is_the_kernels():
    # the fold is a constant of the kernel's source; the twin sums the same columns
    source = (Path(S.__file__).parents[1] / "csrc" / "sym_gemm.cu").read_text()
    fold = re.search(r"constexpr int kFoldColumns = (\d+);", source)
    stage = re.search(r"constexpr int kK = (\d+);", source)
    assert fold and stage
    assert int(fold.group(1)) == S.TF32_SUM_COLUMNS
    assert S.TF32_SUM_COLUMNS % int(stage.group(1)) == 0


def test_split_gram_of_no_rows():
    assert P.split_gram(torch.empty((0, 64)), n=64).shape == (0, 0)
