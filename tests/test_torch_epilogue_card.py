"""The forward's epilogue kernels (``csrc/epilogue.cu``) against their plain twins, on a card.

Every test here needs a CUDA card and skips without one; this file imports no
jax, so it runs on the card's machine with ``--noconftest``.  Given the same
statistics and shift, every element the kernels write is bitwise their twins'
(the chain's float32 steps); the float64 statistics differ from the twins' only
in the order of their sums, so by at most one float32 ulp once rounded.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from seekr_tpu_torch import SeekrPipeline
from seekr_tpu_torch.ops import epilogue_cuda as E
from seekr_tpu_torch.ops import normalize, pearson
from seekr_tpu_torch.ops.count import count_graph
from seekr_tpu_torch.ops.normalize import fused_chain, normalize_counts

MODES = ("Log2.pre", "Log2.post", "Log2.none")
# (mean, std) of a call: computed (None), skipped (False) or given
STAT_CASES = ((None, None), ("given", "given"), ("half", "half"), (None, "given"),
              ("given", None), (False, None), (None, False), (False, False))


def need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def counts_like(m, n, seed, device):
    """Counts per kb as the count kernel writes them: Poisson counts over lengths."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    lengths = torch.randint(300, 3000, (m, 1), generator=g).float()
    raw = torch.poisson(torch.full((m, n), 2.0), generator=g)
    return (raw * (1000.0 / lengths)).to(device)


def stats_for(case, x, which):
    if case in (None, False):
        return case
    if case == "half":  # the benchmark's fault: statistics over half the rows
        rows = x[: x.shape[0] // 2]
        return rows.mean(dim=0) if which == "mean" else rows.std(dim=0, correction=0)
    g = torch.Generator(device="cpu").manual_seed(7)
    v = torch.rand(x.shape[1], generator=g, dtype=torch.float64) + 0.5
    return v.to(x.device)


def bits(t):
    return t.contiguous().view(torch.int32)


def assert_bitwise(got, want):
    # NaN where NaN, every other element the same bits
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(bits(got)[~nan], bits(want)[~nan])


def assert_within_one_ulp(got, want):
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert (bits(got)[~nan].long() - bits(want)[~nan].long()).abs().max().item() <= 1


def run_kernels(x, blocks, mean, std, log2):
    work = E.Normalize(x, blocks, mean, std, pre=log2 == "Log2.pre", post=log2 == "Log2.post")
    if work.needs_stats:
        for index, cols in enumerate(blocks):
            work.stats(index, cols)
    return work


def check_against_twin(raw, mean, std, log2):
    """Kernels and twin on copies of ``raw``: the statistics within one ulp, the
    shift bitwise given the kernels' statistics, each element bitwise given both."""
    blocks = pearson.blocks_of(raw.shape[1])
    x = raw.clone()
    work = run_kernels(x, blocks, mean, std, log2)
    twin = E.NormalizePlain(raw.clone(), blocks, mean, std, pre=work.pre, post=work.post)
    if twin.needs_stats:
        for index, cols in enumerate(blocks):
            twin.stats(index, cols)
    for used, want in ((work.mean, twin.mean), (work.std, twin.std)):
        assert (used is None) == (want is None)
        if used is not None:
            assert_within_one_ulp(used, want)
    # the twin on the kernels' statistics: the exact minimum, and each element
    fed = E.NormalizePlain(raw.clone(), blocks,
                           False if work.mean is None else work.mean,
                           False if work.std is None else work.std,
                           pre=work.pre, post=work.post)
    for index, cols in enumerate(blocks):
        fed.stats(index, cols)
    if work.post:  # the shift; a min of zeros may differ in its sign only
        assert_bitwise(work.running.abs(), fed.running.abs())
    for cols in blocks:
        work.apply(cols)
        fed.apply(cols)
    torch.cuda.synchronize()
    assert_bitwise(x, fed.x)
    return x


@pytest.mark.gpu
@pytest.mark.parametrize("width", [4096, 4 ** 7])
@pytest.mark.parametrize("log2", MODES)
def test_gpu_normalize_kernels_are_the_twin(log2, width):
    device = need_cuda()
    raw = counts_like(700 if width == 4096 else 300, width, seed=width, device=device)
    for case_mean, case_std in STAT_CASES:
        check_against_twin(raw, stats_for(case_mean, raw, "mean"),
                           stats_for(case_std, raw, "std"), log2)


@pytest.mark.gpu
def test_gpu_normalize_kernels_at_the_forward_width():
    device = need_cuda()
    raw = counts_like(13_000, 4096, seed=13, device=device)
    check_against_twin(raw, None, None, "Log2.post")


@pytest.mark.gpu
@pytest.mark.parametrize("log2", MODES)
def test_gpu_zero_std_and_constant_columns_spread_nan_as_the_chain(log2):
    device = need_cuda()
    raw = counts_like(600, 512, seed=3, device=device)
    raw[:, 5] = 0.0   # an empty column: a std of 0
    raw[:, 70] = 2.5  # a constant column (the chain's float32 mean of it may not be exact)
    got = check_against_twin(raw, None, None, log2)
    chain, _, _ = normalize_counts(raw, log2_mode=log2)
    assert torch.isnan(got[:, 5]).all() and torch.isnan(chain[:, 5]).all()
    assert torch.isnan(got[:, 70]).all()
    # Log2.post's min spreads the NaN over the whole matrix, as the chain's does
    assert torch.equal(torch.isnan(got).all(), torch.isnan(chain).all())
    assert torch.isnan(got).all() == (log2 == "Log2.post")


@pytest.mark.gpu
@pytest.mark.parametrize("log2", MODES)
def test_gpu_nan_inf_and_degenerate_given_statistics(log2):
    device = need_cuda()
    base = counts_like(600, 512, seed=4, device=device)
    cases = []
    x = base.clone()
    x[17, 9] = float("nan")
    cases.append((x, None, None))
    x = base.clone()
    x[3, 100] = float("inf")
    cases.append((x, None, None))
    cases.append((x, None, False))
    mean = base.mean(dim=0)
    std = base.std(dim=0, correction=0)
    zero_std = std.clone()
    zero_std[11] = 0.0  # a varying column given a std of 0: scanned
    cases.append((base, mean, zero_std))
    cases.append((base, None, zero_std))
    cases.append((base, False, zero_std))
    at_mean = base.clone()
    at_mean[:, 11] = torch.tensor([1.0, 2.0, 3.0], device=device).repeat(200)
    m11 = mean.clone()
    m11[11] = 2.0  # one element equal to the given mean: 0 / 0
    cases.append((at_mean, m11, zero_std))
    inf_mean = mean.clone()
    inf_mean[20] = float("inf")
    cases.append((base, inf_mean, None))
    cases.append((base, inf_mean, std))
    neg_std = std.clone()
    neg_std[30] = -neg_std[30]
    cases.append((base, None, neg_std))
    cases.append((base, mean, neg_std))
    inf_std = std.clone()
    inf_std[40] = float("inf")
    cases.append((base, None, inf_std))
    for raw, mu, sd in cases:
        check_against_twin(raw, mu, sd, log2)


def row_case(m, n, seed, device):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((m, n), generator=g) * 0.7 + 2.0
    return x.to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("m, n", [(13_000, 4096), (500, 4 ** 7), (64, 8), (33, 4 ** 9)])
def test_gpu_row_kernels_are_the_twin(m, n):
    device = need_cuda()
    x = row_case(m, n, seed=n, device=device)
    x[1, :] = 3.0            # a constant row: 0 / 0
    if m > 5:
        x[5, 2] = float("nan")
    if m > 6:
        x[6, 3] = float("inf")
    blocks = pearson.blocks_of(n)
    moments = E.row_moments(x, blocks)
    for got, want in zip(E.row_stats(x, moments), E.row_stats(x, E.row_moments_plain(x, blocks))):
        assert_within_one_ulp(got, want)
    width = len(range(n)[blocks[0]])
    for cols in blocks[:2] + blocks[-1:]:
        hi, lo = (torch.empty((m, width), device=device) for _ in range(2))
        E.standardize_split(x, moments, cols, hi, lo)
        want = E.standardize_split_plain(x, moments, cols, *(torch.empty_like(hi) for _ in "hl"))
        torch.cuda.synchronize()
        assert_bitwise(hi, want[0])
        assert_bitwise(lo, want[1])


@pytest.mark.gpu
def test_gpu_launchers_check_their_inputs():
    device = need_cuda()
    x = row_case(8, 16, seed=1, device=device)
    for bad in (x[:, :14].contiguous()[:, :10], x.t(), x.double(), x.cpu()):
        with pytest.raises(ValueError):
            E.row_moments(bad, pearson.blocks_of(bad.shape[1]))
    hi = torch.empty((8, 16), device=device)
    with pytest.raises(ValueError):
        E.standardize_split(x, E.row_moments(x, [slice(0, 16)]), slice(0, 16), hi,
                            torch.empty((8, 12), device=device))


def corpus(m, length, seed, device):
    rng = np.random.default_rng(seed)
    bases = rng.integers(0, 4, size=(m, length)).astype(np.int8)
    lengths = rng.integers(length * 3 // 4, length + 1, size=m).astype(np.int32)
    for r in range(m):
        bases[r, lengths[r]:] = 4
    return torch.from_numpy(bases).to(device), torch.from_numpy(lengths).to(device)


def float64_r(raw):
    """Log2.post and Pearson in float64, blocked so the [m, 4^k] copies stay small."""
    c = raw.double()
    mean = c.mean(dim=0)
    std = (c - mean).std(dim=0, correction=0)
    z = (c - mean) / std
    z = torch.log2(z + z.min().abs() + 1.0)
    z = z - z.mean(dim=1, keepdim=True)
    z = z / z.std(dim=1, keepdim=True, correction=0)
    return (z @ z.T) / z.shape[1]


@pytest.mark.gpu
@pytest.mark.parametrize("k, m, blocks", [(6, 2048, 1), (9, 1024, 64)])
def test_gpu_forward_takes_the_kernels_and_holds_r_to_float64(k, m, blocks):
    device = need_cuda()
    if os.environ.get("SEEKR_TPU_MATMUL_PRECISION", "high").lower() != "high":
        pytest.skip("the fused route is the default precision's")
    bases, lengths = corpus(m, 6000 if k == 9 else 1500, seed=k, device=device)
    E.reset_launches()
    before = (dict(normalize.routes), dict(pearson.standardize_routes),
              dict(pearson.gram_routes))
    r = SeekrPipeline(k=k, device=device).forward(bases, lengths)
    torch.cuda.synchronize()
    assert E.launches == dict.fromkeys(E.KERNELS, blocks)
    assert normalize.routes["fused"] == before[0]["fused"] + 1
    assert normalize.routes["torch"] == before[0]["torch"]
    assert pearson.standardize_routes["fused"] == before[1]["fused"] + 1
    assert pearson.standardize_routes["torch"] == before[1]["torch"]
    assert pearson.gram_routes["split"] == before[2]["split"] + 1
    want = float64_r(count_graph(bases, lengths, k))
    assert (r.double() - want).abs().max().item() <= 1e-5


@pytest.mark.gpu
def test_gpu_copies_the_caller_keeps_take_the_kernels_and_leave_its_counts():
    # the same counts normalize to the same bits, handed over or copied
    device = need_cuda()
    raw = counts_like(200, 256, seed=9, device=device)
    kept = raw.clone()
    before = (dict(normalize.routes), dict(E.launches), dict(pearson.standardize_routes))
    copied = normalize_counts(raw)
    assert normalize.routes == {"fused": before[0]["fused"] + 1, "torch": before[0]["torch"]}
    assert E.launches == {**before[1],
                          "epilogue_column_stats": before[1]["epilogue_column_stats"] + 1,
                          "epilogue_normalize": before[1]["epilogue_normalize"] + 1}
    assert torch.equal(raw, kept)
    handed = normalize.normalize_graph(kept, None, None, "Log2.post", inplace=True)
    assert handed[0].data_ptr() == kept.data_ptr()
    for a, b in zip(copied, handed):
        assert_bitwise(a, b)
    pearson.pearson_device(raw, raw)  # not the self Gram: the torch standardization, twice
    assert pearson.standardize_routes["torch"] == before[2]["torch"] + 2
    assert pearson.standardize_routes["fused"] == before[2]["fused"]


@pytest.mark.gpu
def test_gpu_other_precisions_take_the_torch_standardization(monkeypatch):
    device = need_cuda()
    x = row_case(300, 256, seed=2, device=device)
    for value in ("highest", "default"):
        monkeypatch.setenv("SEEKR_TPU_MATMUL_PRECISION", value)
        before = dict(pearson.standardize_routes)
        pearson.pearson_graph(x)
        assert pearson.standardize_routes["torch"] == before["torch"] + 1
        assert pearson.standardize_routes["fused"] == before["fused"]


@pytest.mark.gpu
def test_gpu_fused_pearson_is_the_twins_and_leaves_its_input():
    device = need_cuda()
    x = row_case(1000, 4 ** 7, seed=5, device=device)
    kept = x.clone()
    got = pearson.fused_pearson(x)
    twin = pearson.fused_pearson(x, E.row_moments_plain, E.standardize_split_plain)
    torch.cuda.synchronize()
    assert torch.equal(x, kept)
    # the moments' sums run in another order: r within a few float32 ulp
    assert (got - twin).abs().max().item() <= 1e-6


@pytest.mark.gpu
def test_gpu_fused_chain_leaves_no_counter_set():
    device = need_cuda()
    raw = counts_like(1500, 4 ** 7, seed=8, device=device)
    blocks = pearson.blocks_of(raw.shape[1])
    for _ in range(3):
        fused_chain(raw.clone(), blocks, None, None, "Log2.post")
    torch.cuda.synchronize()
    for counters in E._counters.values():
        assert int(counters.abs().sum()) == 0
