"""The fused epilogue's plain twins (``ops/epilogue_cuda.py``) on the CPU.

The card's kernels are held to these twins bitwise (``test_torch_epilogue_card.py``);
here the twins are held to today's torch chain and to seekr_tpu's normalize and
Pearson.  The twins take their statistics in float64, where the chain takes them in
float32, so the two agree to a few float32 ulp, not bit for bit; with every
statistic given, the same float32 steps give the chain's bits.  The CPU itself
stays on the torch chain (``routes``).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seekr_tpu.ops.normalize import normalize_counts as jax_normalize
from seekr_tpu.ops.pearson import pearson_graph as jax_pearson_graph
from seekr_tpu_torch import SeekrPipeline
from seekr_tpu_torch.ops import epilogue_cuda as E
from seekr_tpu_torch.ops import normalize, pearson
from seekr_tpu_torch.ops.count import count_torch
from seekr_tpu_torch.ops.math import accurate_log2
from seekr_tpu_torch.ops.normalize import fused_chain, normalize_counts, normalize_graph

MODES = ("Log2.pre", "Log2.post", "Log2.none")
CPU = torch.device("cpu")


def raw_counts(m, n, seed, zero_col=None):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(100, 3000, size=m)
    counts = rng.poisson(6.0, size=(m, n)).astype(np.float32)
    counts = counts * (np.float32(1000.0) / lengths[:, None].astype(np.float32))
    if zero_col is not None:
        counts[:, zero_col] = 0.0
    return torch.from_numpy(counts)


def stat(case, raw, which):
    """None computed, False skipped, "given" a vector, "half" the half-batch fault's."""
    if case in (None, False):
        return case
    if case == "half":
        rows = raw[: raw.shape[0] // 2]
        return rows.mean(dim=0) if which == "mean" else rows.std(dim=0, correction=0)
    g = torch.Generator().manual_seed(3)
    return torch.rand(raw.shape[1], generator=g, dtype=torch.float64) + 0.5


STAT_CASES = [(None, None), ("given", "given"), ("half", "half"), (None, "given"),
              ("given", None), (False, None), (None, False), (False, False)]


def twin(raw, mean, std, log2):
    x = raw.clone()
    work = fused_chain(x, pearson.blocks_of(x.shape[1]), mean, std, log2,
                       engine=E.NormalizePlain)
    return x, work


@pytest.mark.parametrize("stats", STAT_CASES, ids=str)
@pytest.mark.parametrize("log2", MODES)
@pytest.mark.parametrize("n", [256, 4 ** 7])
def test_twin_normalize_is_the_chain(n, log2, stats):
    raw = raw_counts(40, n, seed=n)
    mean, std = stat(stats[0], raw, "mean"), stat(stats[1], raw, "std")
    got, work = twin(raw, mean, std, log2)
    want, want_mean, want_std = normalize_graph(raw, mean, std, log2)
    for used, chain in ((work.mean, want_mean), (work.std, want_std)):
        assert (used is None) == (chain is None)
        if used is not None:
            torch.testing.assert_close(used, chain.reshape(-1), rtol=2e-6, atol=0)
    if None in stats:
        # float64 statistics against the chain's float32 ones: a few ulp of each
        # value, 1e-5 being the north star's count tolerance
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5, equal_nan=True)
    else:  # the same statistics: the chain's float32 steps, bit for bit
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("log2", MODES)
def test_twin_normalize_is_seekr_tpus(log2):
    raw = raw_counts(48, 256, seed=5)
    got, work = twin(raw, None, None, log2)
    want, want_mean, want_std = jax_normalize(jnp.asarray(raw.numpy()), log2_mode=log2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(work.mean.numpy(), np.asarray(want_mean).reshape(-1), rtol=1e-6)
    np.testing.assert_allclose(work.std.numpy(), np.asarray(want_std).reshape(-1), rtol=1e-6)


@pytest.mark.parametrize("log2", MODES)
def test_twin_statistics_are_float64s_rounded(log2):
    raw = raw_counts(64, 4 ** 7, seed=8)
    _, work = twin(raw, None, None, log2)
    y = accurate_log2(raw + 1.0) if log2 == "Log2.pre" else raw
    y = y.double()
    want_mean = y.mean(dim=0)
    want_std = (y - want_mean).pow(2).mean(dim=0).sqrt()
    for got, want in ((work.mean, want_mean), (work.std, want_std)):
        ulp = (got.view(torch.int32).long() - want.float().view(torch.int32).long()).abs()
        assert ulp.max().item() <= 1


@pytest.mark.parametrize("log2", MODES)
def test_twin_zero_std_column_spreads_nan_as_the_chain(log2):
    raw = raw_counts(24, 4 ** 7, seed=2, zero_col=9000)  # block 2 of 4
    got, work = twin(raw, None, None, log2)
    want, _, want_std = normalize_graph(raw, None, None, log2)
    assert work.std[9000] == 0 and want_std[9000] == 0
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.isnan(got).all() == (log2 == "Log2.post")
    jax_want = np.asarray(jax_normalize(jnp.asarray(raw.numpy()), log2_mode=log2)[0])
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(jax_want))


def test_twin_nan_in_a_column_spreads_under_log2_post():
    raw = raw_counts(24, 256, seed=6)
    raw[3, 17] = float("nan")
    got, _ = twin(raw, None, None, "Log2.post")
    assert torch.isnan(got).all()
    assert torch.isnan(normalize_graph(raw, None, None, "Log2.post")[0]).all()


def test_twin_shift_is_the_min_over_every_block():
    # the smallest standardized value sits in the last block: the running
    # minimum has to carry it to the shift every block is applied with
    raw = raw_counts(30, 4 ** 7, seed=12)
    raw[:, -1] = torch.linspace(0.0, 1e4, 30)
    _, work = twin(raw, None, None, "Log2.post")
    z = (raw - work.mean) / work.std
    assert work.running.tolist() == sorted(work.running.tolist(), reverse=True)
    assert work.running[-1] == z.min() and z.argmin() % raw.shape[1] == raw.shape[1] - 1


def corpus(k, m, length, seed):
    rng = np.random.default_rng(seed)
    bases = rng.integers(0, 4, size=(m, length)).astype(np.int8)
    lengths = rng.integers(length * 3 // 4, length + 1, size=m).astype(np.int32)
    for r in range(m):
        bases[r, lengths[r]:] = 4
    return torch.from_numpy(bases), torch.from_numpy(lengths)


@pytest.mark.parametrize("k", [4, 7])
def test_twin_forward_is_the_chains_and_seekr_tpus(k):
    # k = 7: 4 column blocks, the blocked path of every twin on the CPU
    bases, lengths = corpus(k, 40, 9000 if k == 7 else 2000, seed=k)
    raw = count_torch(bases, lengths, k)
    x, _ = twin(raw, None, None, "Log2.post")
    kept = x.clone()
    got = pearson.fused_pearson(x, E.row_moments_plain, E.standardize_split_plain)
    assert torch.equal(x, kept)  # the fused route only reads its operand
    want = SeekrPipeline(k=k, device=CPU).forward(bases, lengths)
    assert not torch.isnan(got).any()
    assert (got - want).abs().max().item() <= 2e-6
    normalized = np.asarray(jax_normalize(jnp.asarray(raw.numpy()), log2_mode="Log2.post")[0])
    jax_r = np.asarray(jax_pearson_graph(jnp.asarray(normalized)))
    assert np.abs(got.numpy() - jax_r).max() <= 1e-5


def test_twin_row_moments_and_split():
    g = torch.Generator().manual_seed(4)
    x = torch.randn((30, 4 ** 7), generator=g) * 0.5 + 3.0
    blocks = pearson.blocks_of(x.shape[1])
    mean, std = E.row_stats(x, E.row_moments_plain(x, blocks))
    xd = x.double()
    for got, want in ((mean, xd.mean(dim=1)), (std, xd.std(dim=1, correction=0))):
        ulp = (got.view(torch.int32).long() - want.float().view(torch.int32).long()).abs()
        assert ulp.max().item() <= 1
    hi, lo = E.standardize_split_plain(x, E.row_moments_plain(x, blocks), blocks[1],
                                       torch.empty(30, 4096), torch.empty(30, 4096))
    a = (x[:, 4096:8192] - mean[:, None]) / std[:, None]
    assert torch.equal(hi, pearson.round_to_tf32(a))
    assert torch.equal(lo, pearson.round_to_tf32(a - hi))


def test_stats_from_moments_edges():
    s = torch.tensor([0.0, float("nan"), 1e-17, 4.0], dtype=torch.float64)
    q = torch.tensor([0.0, 1.0, 0.0, 8.0], dtype=torch.float64)
    pivot = torch.tensor([2.5, 1.0, 0.0, 1.0])
    mean, std = E.stats_from_moments(s, q, 4, pivot)
    assert mean.tolist()[0] == 2.5 and std.tolist()[0] == 0.0  # constant: std 0
    assert torch.isnan(mean[1]) and torch.isnan(std[1])  # NaN carries
    assert std[2] == 0.0  # a variance that rounds below 0 is 0
    assert mean[3] == 2.0 and std[3] == 1.0


def test_cpu_takes_the_torch_chain_bitwise():
    bases, lengths = corpus(6, 32, 2000, seed=1)
    raw = count_torch(bases, lengths, 6)
    before = (dict(normalize.routes), dict(pearson.standardize_routes), dict(E.launches))
    got = SeekrPipeline(k=6, device=CPU).forward(bases, lengths)
    assert normalize.routes == {"fused": before[0]["fused"], "torch": before[0]["torch"] + 1}
    assert pearson.standardize_routes == {"fused": before[1]["fused"],
                                          "torch": before[1]["torch"] + 1}
    assert E.launches == before[2]
    # the parent's chain, written out
    x = raw.clone()
    mean = x.mean(dim=0)
    x.sub_(mean)
    x.div_(x.std(dim=0, correction=0))
    x = accurate_log2(x + x.min().abs() + 1.0)
    x = x - x.mean(dim=1, keepdim=True)
    x = x.div_(x.std(dim=1, keepdim=True, correction=0))
    assert torch.equal(got, (x @ x.T) / torch.tensor(float(x.shape[1])))
    kept = raw.clone()
    normalize_counts(raw)
    assert normalize.routes["torch"] == before[0]["torch"] + 2
    assert torch.equal(raw, kept)


def test_launchers_refuse_cpu_tensors():
    x = torch.ones((8, 16))
    blocks = pearson.blocks_of(16)
    assert not E.takes(x)
    with pytest.raises(ValueError):
        E.Normalize(x, blocks, None, None, pre=False, post=True).stats(0, blocks[0])
    with pytest.raises(ValueError):
        E.Normalize(x, blocks, None, None, pre=False, post=True).apply(blocks[0])
    with pytest.raises(ValueError):
        E.row_moments(x, blocks)
    with pytest.raises(ValueError):
        E.standardize_split(x, (torch.zeros(8, dtype=torch.float64),) * 2, blocks[0],
                            torch.empty(8, 16), torch.empty(8, 16))
