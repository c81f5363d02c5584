"""The symmetric split-TF32 GEMM (``csrc/sym_gemm.cu``) on a card.

Every test here needs a CUDA card and skips without one; this file imports no
jax, so it runs on the card's machine with ``--noconftest``.  The kernel's r is
held to float64, to its plain twin (``ops/sym_gemm_cuda.sym_split_gemm_plain``,
float32 products, so within a few float32 ulp of r) and to the cuBLAS composition
it replaced (``chip_smoke.cublas_composition``) for where NaN falls; r must be
exactly symmetric, bit for bit.
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

from seekr_tpu_torch.ops import pearson as P
from seekr_tpu_torch.ops import sym_gemm_cuda as S

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402


def need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def operand(m, n, seed, device, nan_rows=()):
    """Row-standardized gamma counts [m, n] float32 on the card, NaN rows where asked."""
    g = torch.Generator(device=device).manual_seed(seed)
    raw = torch.empty((m, n), device=device).exponential_(generator=g)
    raw += torch.empty((m, n), device=device).exponential_(generator=g)  # gamma(2, 1)
    a = P._row_standardize(raw, inplace=True)
    for row in nan_rows:
        a[row] = float("nan")
    return a


def float64_r(a):
    a64 = a.double()
    return (a64 @ a64.T) / a.shape[1]


def bitwise_symmetric(r):
    bits = r.view(torch.int32)
    return torch.equal(bits, bits.T)


def max_err(got, want):
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    return (got.double() - want)[~nan].abs().max().item() if (~nan).any() else 0.0


@pytest.mark.gpu
def test_gpu_kernel_at_the_k6_forward_shape():
    device = need_cuda()
    a = operand(13_000, 4096, seed=1, device=device)
    before = dict(P.sym_gemm)
    r = P.split_gram(a, n=4096)
    torch.cuda.synchronize()
    assert P.sym_gemm == {"launches": before["launches"] + 1,
                          "tiles": before["tiles"] + 5253}
    assert bitwise_symmetric(r)
    assert max_err(r, float64_r(a)) <= 6e-6


@pytest.mark.gpu
def test_gpu_kernel_on_a_k9_buffer():
    # 262,144 columns: 64 launches, each adding its block into the r written before
    device = need_cuda()
    a = operand(1024, 4 ** 9, seed=2, device=device)
    before = dict(P.sym_gemm)
    r = P.split_gram(a, n=a.shape[1])
    torch.cuda.synchronize()
    assert P.sym_gemm == {"launches": before["launches"] + 64,
                          "tiles": before["tiles"] + 64 * S.tiles_of(1024)}
    assert bitwise_symmetric(r)
    assert max_err(r, float64_r(a)) <= 8.5e-6


@pytest.mark.gpu
@pytest.mark.parametrize("nan_rows", [(0,), (5, 200, 1299)])
def test_gpu_nan_rows_and_columns_where_the_parents_route_has_them(nan_rows):
    device = need_cuda()
    a = operand(1300, 4096, seed=3, device=device, nan_rows=nan_rows)
    r = P.split_gram(a, n=4096)
    parent = chip_smoke.cublas_composition(*P.split_tf32(a), a.shape[1])
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(r), torch.isnan(parent))
    for row in nan_rows:
        assert torch.isnan(r[row]).all() and torch.isnan(r[:, row]).all()
    assert bitwise_symmetric(r)
    assert max_err(r, float64_r(a)) <= 6e-6


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 127, 129])
@pytest.mark.parametrize("n", [4096, 100, 4096 + 36, 4096 + 37])
def test_gpu_small_and_ragged_shapes(m, n):
    # rows and columns past the edges of the tiles and of a stage; at 4,096 + 37
    # the last block's halves are 37 columns in rows 40 apart, so ld != w
    device = need_cuda()
    a = operand(m, n, seed=m * n, device=device)
    r = P.split_gram(a, n=n)
    hi, lo = P.split_tf32(a)
    twin = torch.empty_like(r)
    blocks = P.blocks_of(n)
    for i, cols in enumerate(blocks):
        S.sym_split_gemm_plain(hi[:, cols], lo[:, cols], twin, i == 0, i == len(blocks) - 1, n)
    torch.cuda.synchronize()
    assert bitwise_symmetric(r)
    assert max_err(r, float64_r(a)) <= 6e-6
    assert (r - twin).abs().max().item() <= 6e-6


@pytest.mark.gpu
def test_gpu_counts_the_kernels_launches_and_not_the_twins():
    # a first block, then a last one adding into it: two launches of the kernel;
    # the twin on the same card tensors launches nothing and counts nothing
    device = need_cuda()
    a = operand(700, 4096, seed=4, device=device)
    hi, lo = P.split_tf32(a)
    r = torch.empty((700, 700), device=device)
    before = dict(S.counts)
    S.sym_split_gemm(hi, lo, r, True, False, 8192)
    S.sym_split_gemm(hi, lo, r, False, True, 8192)
    assert S.counts == {"launches": before["launches"] + 2,
                        "tiles": before["tiles"] + 2 * S.tiles_of(700)}
    twin = torch.empty_like(r)
    S.sym_split_gemm_plain(hi, lo, twin, True, False, 8192)
    S.sym_split_gemm_plain(hi, lo, twin, False, True, 8192)
    torch.cuda.synchronize()
    assert S.counts["launches"] == before["launches"] + 2
    assert bitwise_symmetric(r)
    assert max_err(r, float64_r(a)) <= 6e-6
    assert (r - twin).abs().max().item() <= 6e-6


@pytest.mark.gpu
def test_gpu_launcher_checks_its_inputs():
    device = need_cuda()
    a = operand(64, 4096, seed=5, device=device)
    hi, lo = P.split_tf32(a)
    out = torch.empty((64, 64), device=device)
    bad = [
        (hi[:, 1:], lo[:, 1:], out),                # rows not 16-byte aligned
        (hi, lo[:32], out),                         # halves of two shapes
        (hi, lo, torch.empty((64, 64))),            # out on the host
        (hi, lo, torch.empty((64, 63), device=device)),
        (hi.double(), lo.double(), out),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            S.sym_split_gemm(*args, True, True, 4096)
