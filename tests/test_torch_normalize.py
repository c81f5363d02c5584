"""The port's log2 and normalize chain against seekr_tpu's, on the CPU.

``accurate_log2`` uses the same bitcast/atanh construction out of exactly
rounded operations, so it is bitwise equal on normal floats.  The normalize
chain reduces columns in another order than XLA, so it is held to 1e-6
(rtol and atol), with NaN where seekr_tpu has NaN.  Denormal inputs are left
out: XLA on the CPU flushes them to zero, and the count path never feeds
them (its inputs are counts + 1 >= 1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seekr_tpu.ops import math as jax_math
from seekr_tpu.ops.normalize import normalize_counts as jax_normalize
from seekr_tpu_torch.ops import math as torch_math
from seekr_tpu_torch.ops.normalize import normalize_counts
from seekr_tpu_torch.utils.state import from_jax_state

MODES = ["Log2.pre", "Log2.post", "Log2.none"]


def normal_floats(n, seed):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0x00800000, 0x7F800000, size=n, dtype=np.int64).astype(np.int32)
    return np.concatenate([bits.view(np.float32),
                           rng.uniform(1.0, 5000.0, size=n).astype(np.float32),
                           np.array([1.0, 2.0, 1.4142135, 1.4142137, 3.4e38], np.float32)])


@pytest.mark.parametrize("fn", ["accurate_log2", "log2_1p"])
def test_log2_bitwise_on_normal_floats(fn):
    x = normal_floats(200_000, seed=1)
    if fn == "log2_1p":
        x = x[x < 1e38]  # x + 1 stays finite
    got = getattr(torch_math, fn)(torch.from_numpy(x)).numpy()
    want = np.asarray(getattr(jax_math, fn)(jnp.asarray(x)))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_log2_special_values_delegate():
    x = np.array([0.0, -1.0, np.inf, np.nan], np.float32)
    got = torch_math.accurate_log2(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_math.accurate_log2(jnp.asarray(x))))


def raw_counts(seed, m=48, n=64, zero_col=False):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(100, 3000, size=m)
    counts = rng.poisson(6.0, size=(m, n)).astype(np.float32)
    counts = counts * (np.float32(1000.0) / lengths[:, None].astype(np.float32))
    if zero_col:
        counts[:, 5] = 0.0
    return counts


def assert_close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6, atol=1e-6,
                               equal_nan=True)


@pytest.mark.parametrize("log2", MODES)
@pytest.mark.parametrize("stats", ["computed", "provided", "skipped"])
def test_normalize_counts_matches(log2, stats):
    counts = raw_counts(seed=MODES.index(log2))
    if stats == "computed":
        kw_jax = kw_port = dict(mean=True, std=True)
    elif stats == "skipped":
        kw_jax = kw_port = dict(mean=False, std=False)
    else:
        # seekr_tpu's norm vectors of another corpus, carried across
        _, mean, std = jax_normalize(raw_counts(seed=99), log2_mode=log2)
        state = {"mean": np.asarray(mean), "std": np.asarray(std)}
        kw_jax = state
        kw_port = from_jax_state(state, "cpu")
    want, want_mean, want_std = jax_normalize(counts, log2_mode=log2, **kw_jax)
    got, got_mean, got_std = normalize_counts(torch.from_numpy(counts), log2_mode=log2,
                                              **kw_port)
    assert got.dtype == torch.float32 and got.shape == counts.shape
    assert not np.isnan(np.asarray(want)).any()  # the comparison is not vacuous
    assert_close(got, want)
    if stats == "skipped":
        assert got_mean is None and got_std is None and want_mean is None
    else:
        assert_close(got_mean, want_mean)
        assert_close(got_std, want_std)


def test_mean_only_and_std_only():
    counts = raw_counts(seed=7)
    for mean, std in ((True, False), (False, True)):
        want, _, _ = jax_normalize(counts, mean=mean, std=std)
        got, _, _ = normalize_counts(torch.from_numpy(counts), mean=mean, std=std)
        assert_close(got, want)


@pytest.mark.parametrize("log2", MODES)
def test_zero_std_column_nan_matches(log2):
    # a k-mer absent from every row: std 0 -> NaN, spread by Log2.post's min
    counts = raw_counts(seed=11, zero_col=True)
    want, _, _ = jax_normalize(counts, log2_mode=log2)
    got, _, _ = normalize_counts(torch.from_numpy(counts), log2_mode=log2)
    assert np.isnan(np.asarray(want)).any()
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(np.asarray(want)))
    assert_close(got, want)


def test_normalize_leaves_input_untouched():
    counts = torch.from_numpy(raw_counts(seed=3))
    before = counts.clone()
    normalize_counts(counts, log2_mode="Log2.none")
    assert torch.equal(counts, before)


def test_bad_log2_mode_raises():
    with pytest.raises(ValueError, match="log2 must be one of"):
        normalize_counts(torch.zeros(2, 4), log2_mode="Log2.bogus")


def test_from_jax_state_casts_and_flattens():
    from seekr_tpu.ops.count import count_graph

    rng = np.random.default_rng(0)
    bases = rng.integers(0, 4, size=(3, 50), dtype=np.int8)
    lengths = np.full(3, 50, np.int32)
    counts3 = np.asarray(count_graph(jnp.asarray(bases), jnp.asarray(lengths), 4, flat=False))
    flat = np.asarray(count_graph(jnp.asarray(bases), jnp.asarray(lengths), 4))
    assert counts3.ndim == 3
    out = from_jax_state({"counts": counts3, "mean": np.ones(256, np.float64)}, "cpu")
    assert out["counts"].shape == (3, 256) and out["counts"].dtype == torch.float32
    np.testing.assert_array_equal(out["counts"].numpy(), flat)
    assert out["mean"].dtype == torch.float32 and out["mean"].shape == (256,)
