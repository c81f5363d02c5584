"""The normalize chain and the row standardization over column blocks.

Past ``ops.pearson.GEMM_CHUNK`` (4,096) columns, k >= 7, both run block by
block on one buffer; at k <= 6 there is one block, and both are the plain
unblocked chain, bit for bit.  The references are the benchmark's float64 plain
references (``benchmarks/reference/``), loaded by path: ``kmer_ref.py`` and its
column-blocked, in-place copy ``kmer_ref_blocked.py``.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from seekr_tpu_torch import SeekrPipeline
from seekr_tpu_torch.ops import normalize, pearson
from seekr_tpu_torch.ops.count import count_graph, count_torch
from seekr_tpu_torch.ops.math import accurate_log2
from seekr_tpu_torch.ops.normalize import normalize_counts, normalize_graph

CPU = torch.device("cpu")
REFERENCE = Path(__file__).resolve().parents[1] / "benchmarks" / "reference"


def _load(name):
    spec = importlib.util.spec_from_file_location(f"ref_{name}", REFERENCE / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REFS = {name: _load(name) for name in ("kmer_ref", "kmer_ref_blocked")}


def corpus(k, m, length, seed):
    """Uniform bases with about one N in 2,000, lengths in [3/4, 1] of ``length``."""
    rng = np.random.default_rng(seed)
    bases = rng.integers(0, 4, size=(m, length)).astype(np.int8)
    bases[rng.random((m, length)) < 5e-4] = 4
    lengths = rng.integers(length * 3 // 4, length + 1, size=m).astype(np.int32)
    for r in range(m):
        bases[r, lengths[r]:] = 4
    return torch.from_numpy(bases), torch.from_numpy(lengths)


def reference_r(ref, bases, lengths, k):
    c = ref.counts_per_kb(bases, lengths, k)
    assert int((c.sum(dim=0) == 0).sum()) == 0  # every column counted: no std of 0
    mean, std = ref.column_stats(c)
    z = ref.standardize_rows(ref.log2_post(c, mean, std))
    return ref.pearson(z, z)


# k = 7: 4 blocks; k = 9: 64.  Sizes give ~20 windows a column, so no column is
# empty and none has a std of 0.
SIZES = {7: (40, 9000), 9: (64, 80000)}


@pytest.mark.parametrize("ref", sorted(REFS))
@pytest.mark.parametrize("k", sorted(SIZES))
def test_blocked_forward_matches_the_float64_reference(k, ref):
    bases, lengths = corpus(k, *SIZES[k], seed=k)
    got = SeekrPipeline(k=k, log2="Log2.post", device=CPU).forward(bases, lengths)
    want = reference_r(REFS[ref], bases, lengths, k)
    assert not torch.isnan(got).any()
    # float32 throughout: each normalized value a few ulp off (6e-8 each), and r
    # a sum of products of unit-variance rows over n columns divided by n, so
    # its error is a few ulp of 1 (2.4e-7 read here at k = 7 and 9); 2e-6 is
    # ~30 ulp, while one half-width statistic or a TF32 product is far outside
    assert (got.double() - want).abs().max().item() <= 2e-6


def _unblocked_chain(raw):
    """The Log2.post chain with computed statistics, unblocked, written out."""
    mean = raw.mean(dim=0)
    x = raw - mean
    std = x.std(dim=0, correction=0)
    x = x.div_(std)
    shift = x.min().abs()
    return accurate_log2(x + shift + 1.0), mean, std


def _unblocked_forward(raw):
    x, _, _ = _unblocked_chain(raw)
    x = x - x.mean(dim=1, keepdim=True)
    x = x.div_(x.std(dim=1, keepdim=True, correction=0))
    return (x @ x.T) / torch.tensor(float(x.shape[1]))


@pytest.mark.parametrize("k", [3, 5, 6])
def test_one_block_is_the_unblocked_chain_bitwise(k):
    bases, lengths = corpus(k, 48, 3000, seed=k)
    raw = count_torch(bases, lengths, k)
    before = dict(normalize.column_blocks)
    got = SeekrPipeline(k=k, device=CPU).forward(bases, lengths)
    assert normalize.column_blocks["normalize"] == before["normalize"] + 1
    assert torch.equal(got, _unblocked_forward(raw.clone()))
    kept = raw.clone()
    for a, b in zip(normalize_counts(raw), _unblocked_chain(raw.clone())):
        assert torch.equal(a, b)
    assert torch.equal(raw, kept)  # the caller's counts are left as they were


def test_blocked_chain_leaves_the_callers_counts_and_matches_in_place():
    bases, lengths = corpus(7, 40, 9000, seed=17)
    raw = count_torch(bases, lengths, 7)
    kept = raw.clone()
    copied = normalize_counts(raw)
    assert torch.equal(raw, kept)
    handed = normalize_graph(raw, None, None, "Log2.post", inplace=True)
    assert handed[0].data_ptr() == raw.data_ptr()  # the buffer itself, overwritten
    for a, b in zip(copied, handed):
        assert torch.equal(a, b)
    standardized = pearson.standardize_rows(copied[0], device=CPU)
    assert not torch.equal(standardized, copied[0])  # a copy: the input kept
    assert torch.equal(pearson._row_standardize(copied[0].clone(), inplace=True), standardized)


@pytest.mark.parametrize("log2", ["Log2.pre", "Log2.none"])
def test_blocked_chain_with_given_and_skipped_statistics(log2):
    # given vectors and a skipped step, blocked, against the same steps on the
    # whole matrix: column-wise steps give the same bits block by block
    bases, lengths = corpus(7, 24, 6000, seed=3)
    raw = count_torch(bases, lengths, 7)
    mean = torch.rand(4 ** 7, dtype=torch.float64)
    for given_mean, given_std in ((mean, False), (False, None), (None, mean + 1.0)):
        got = normalize_graph(raw, given_mean, given_std, log2)
        x = accurate_log2(raw + 1.0) if log2 == "Log2.pre" else raw
        if given_mean is not False:
            want_mean = x.mean(dim=0) if given_mean is None else given_mean.float()
            x = x - want_mean
        if given_std is not False:
            want_std = x.std(dim=0, correction=0) if given_std is None else given_std.float()
            x = x / want_std
        # bit for bit, the NaN of an empty column (std 0) included
        torch.testing.assert_close(got[0], x, rtol=0, atol=0, equal_nan=True)
        assert (got[1] is None) == (given_mean is False)
        assert (got[2] is None) == (given_std is False)
        if given_std is not False:
            assert torch.equal(got[2], want_std)


# (mean, std) of each call: computed (None), skipped (False) or given
STAT_CASES = ((None, None), (False, None), (None, False), (False, False),
              ("given", "given"), ("given", None))


@pytest.mark.parametrize("inplace", [False, True])
@pytest.mark.parametrize("layout", ["flat", "unflattened"])
@pytest.mark.parametrize("log2", ["Log2.pre", "Log2.post", "Log2.none"])
def test_one_block_chain_is_the_plain_chain_bitwise(log2, layout, inplace):
    # at k = 6 the blocked loop runs once over the whole width: its output and
    # statistics are the plain chain's on the whole tensor, bits and shapes
    bases, lengths = corpus(6, 24, 3000, seed=29)
    raw = count_torch(bases, lengths, 6)
    if layout == "unflattened":
        raw = raw.reshape(24, 16, 256)
    g = torch.Generator().manual_seed(29)
    given = torch.rand(raw.shape[1:], generator=g, dtype=torch.float64) + 0.5
    for case_mean, case_std in STAT_CASES:
        mean = given if case_mean == "given" else case_mean
        std = given + 1.0 if case_std == "given" else case_std
        x = raw.clone()
        before = normalize.column_blocks["normalize"]
        got, got_mean, got_std = normalize_graph(x, mean, std, log2, inplace=inplace)
        assert normalize.column_blocks["normalize"] == before + 1

        want = accurate_log2(raw + 1.0) if log2 == "Log2.pre" else raw
        want_mean = want_std = None
        if mean is not False:
            want_mean = want.mean(dim=0) if mean is None else mean.float()
            want = want - want_mean
        if std is not False:
            want_std = want.std(dim=0, correction=0) if std is None else std.float()
            want = want / want_std
        if log2 == "Log2.post":
            want = accurate_log2(want + want.min().abs() + 1.0)
        assert got.shape == raw.shape
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
        for a, b in ((got_mean, want_mean), (got_std, want_std)):
            assert (a is None) == (b is None)
            assert b is None or (a.shape == b.shape and torch.equal(a, b))
        if inplace:  # the caller's buffer, overwritten
            assert got.data_ptr() == x.data_ptr()
        else:
            assert torch.equal(x, raw)


def test_a_zero_std_column_in_one_block_spreads_nan_everywhere():
    g = torch.Generator().manual_seed(5)
    raw = torch.rand((6, 4 ** 7), generator=g) * 100.0
    raw[:, 9000] = 3.0  # block 2 of 4: centred to 0, then 0 / 0
    normalized, _, std = normalize_counts(raw)
    assert std[9000] == 0 and torch.isnan(normalized).all()
    assert torch.isnan(pearson.pearson_graph(normalized)).all()
    for ref in REFS.values():
        c = raw.double()
        z = ref.standardize_rows(ref.log2_post(c, *ref.column_stats(c)))
        assert torch.isnan(z).all()


def test_the_blocked_reference_is_the_reference():
    bases, lengths = corpus(7, 20, 3000, seed=11)
    plain, blocked = REFS["kmer_ref"], REFS["kmer_ref_blocked"]
    c = plain.counts_per_kb(bases, lengths, 7)
    assert torch.equal(c, blocked.counts_per_kb(bases, lengths, 7))
    g = torch.Generator().manual_seed(11)
    x = torch.rand((20, 3 * 4096 + 100), generator=g, dtype=torch.float64) * 5.0
    stats = plain.column_stats(x)
    for a, b in zip(stats, blocked.column_stats(x)):
        assert torch.equal(a, b)
    for per_row in (False, True):
        want = plain.log2_post(x, *stats, per_row=per_row)
        got = blocked.log2_post(x.clone(), *stats, per_row=per_row)
        assert torch.equal(got, want)
        # the row sums run over the blocks: float64 rounding apart
        torch.testing.assert_close(blocked.standardize_rows(got), plain.standardize_rows(want),
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("k, blocks", [(6, 1), (9, 64)])
def test_the_block_and_piece_counters(k, blocks):
    bases, lengths = corpus(k, 4, 300, seed=1)
    before = (normalize.column_blocks["normalize"], pearson.column_blocks["gram"],
              pearson.column_blocks["standardize"])
    SeekrPipeline(k=k, device=CPU).forward(bases, lengths)
    after = (normalize.column_blocks["normalize"], pearson.column_blocks["gram"],
             pearson.column_blocks["standardize"])
    assert [b - a for a, b in zip(before, after)] == [blocks] * 3


def need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def past_2_31():
    """8,400 rows at k = 9 on the card: rows from 8,192 on start past element
    2^31 of the [m, 4^9] output."""
    device = need_cuda()
    return tuple(t.to(device) for t in corpus(9, 8400, 2000, seed=31))


@pytest.mark.gpu
def test_gpu_k9_count_past_element_2_31_is_count_torch(past_2_31):
    bases, lengths = past_2_31
    got = count_graph(bases, lengths, 9)
    assert got.numel() > 2 ** 31
    assert torch.equal(got[8192:], count_torch(bases[8192:], lengths[8192:], 9))


@pytest.mark.gpu
def test_gpu_k9_forward_peak_memory_is_near_one_count_buffer(past_2_31):
    bases, lengths = past_2_31
    device = bases.device
    pipe = SeekrPipeline(k=9, device=device)
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    r = pipe.forward(bases, lengths)
    torch.cuda.synchronize(device)
    buffer = bases.shape[0] * 4 ** 9 * 4
    peak = torch.cuda.max_memory_allocated(device)
    assert not torch.isnan(r).any()
    # the count buffer, worked in place, plus one block's temporaries and the
    # [m, m] products (the whole chain took ~11.5 buffers)
    assert peak <= 2.2 * buffer, (peak, buffer)
