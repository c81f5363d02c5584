"""The port's Pearson functions against seekr_tpu's, on the CPU.

Both compute row-standardize + an fp32 GEMM / n_cols; the sums run in other
orders, so results agree within 1e-5 (seekr_tpu's own GEMM budget against
numpy).  The port's GEMM runs in full float32 whatever precision the caller
set globally, and restores the caller's setting afterwards.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seekr_tpu.models.pearson import pearson as jax_pearson
from seekr_tpu.ops import pearson as jax_ops
from seekr_tpu_torch.models.pearson import _equal_content, mirror_upper_inplace, pearson
from seekr_tpu_torch.ops import pearson as torch_ops
from seekr_tpu_torch.ops.precision import pearson_precision

TOL = dict(rtol=1e-5, atol=1e-5)


def counts(seed, m=40, n=256):
    rng = np.random.default_rng(seed)
    return rng.gamma(2.0, 1.0, size=(m, n)).astype(np.float32)


def test_pearson_device_matches():
    a, b = counts(0), counts(1, m=23)
    for row_standardize in (True, False):
        want = np.asarray(jax_ops.pearson_device(a, b, row_standardize=row_standardize))
        got = torch_ops.pearson_device(a, b, row_standardize=row_standardize, device="cpu")
        assert got.dtype == torch.float32 and got.shape == (40, 23)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_pearson_graph_flat_and_3d():
    a = counts(2)
    want = np.asarray(jax_ops.pearson_graph(jnp.asarray(a)))
    got = torch_ops.pearson_graph(torch.from_numpy(a))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    got3 = torch_ops.pearson_graph(torch.from_numpy(a).view(40, 2, 128))
    np.testing.assert_allclose(got3.numpy(), got.numpy(), rtol=0, atol=1e-6)


def test_standardized_targets_path_is_bitwise_pearson_device():
    q, t = counts(3, m=7), counts(4, m=31)
    t_std = torch_ops.standardize_rows(t, device="cpu")
    np.testing.assert_allclose(t_std.numpy(), np.asarray(jax_ops.standardize_rows(t)), **TOL)
    got = torch_ops.pearson_against_standardized(q, t_std, device="cpu")
    assert torch.equal(got, torch_ops.pearson_device(q, t, device="cpu"))
    want = np.asarray(jax_ops.pearson_against_standardized(q, jax_ops.standardize_rows(t)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("block_rows", [7, 40, 4096])
def test_pearson_blocked_matches(block_rows):
    a, b = counts(5), counts(6, m=17)
    got = torch_ops.pearson_blocked(a, b, block_rows=block_rows, device="cpu")
    want = jax_ops.pearson_blocked(a, b, block_rows=block_rows)
    assert isinstance(got, np.ndarray) and got.shape == (40, 17)
    np.testing.assert_allclose(got, want, **TOL)


def test_public_pearson_matches_and_is_symmetric(tmp_path):
    a = counts(7)
    out = tmp_path / "r.npy"
    got = pearson(a, a, outfile=str(out), device="cpu")
    want = jax_pearson(a, a)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got, got.T)
    np.testing.assert_array_equal(np.load(out), got)
    # equal content in two arrays is a self-comparison too
    np.testing.assert_array_equal(pearson(a, a.copy(), device="cpu"), got)
    b = counts(8, m=12)
    np.testing.assert_allclose(pearson(a, b, device="cpu"), jax_pearson(a, b), **TOL)


def test_public_pearson_blocked_path(monkeypatch):
    import seekr_tpu_torch.models.pearson as mod

    a = counts(9, m=70)
    monkeypatch.setattr(mod, "STREAM_CELL_THRESHOLD", 100)
    got = pearson(a, a, device="cpu")
    np.testing.assert_array_equal(got, got.T)
    np.testing.assert_allclose(got, jax_pearson(a, a), **TOL)


def test_public_pearson_takes_tensors():
    a = counts(10)
    t = torch.from_numpy(a)
    got = pearson(t, t, device="cpu")
    np.testing.assert_array_equal(got, got.T)
    np.testing.assert_allclose(got, jax_pearson(a, a), **TOL)


def test_equal_content_and_mirror():
    a = counts(11)
    b = a.copy()
    b[30, 3] += 1
    assert _equal_content(a, a.copy()) and not _equal_content(a, b)
    nan = a.copy()
    nan[:, 4] = np.nan
    assert _equal_content(nan, nan.copy())
    assert _equal_content(np.arange(6).reshape(2, 3), np.arange(6).reshape(2, 3))
    sq = np.arange(49, dtype=np.float32).reshape(7, 7)
    mirror_upper_inplace(sq, block=3)
    np.testing.assert_array_equal(sq, sq.T)
    assert sq[0, 6] == 6 and sq[6, 0] == 6


def test_global_tf32_setting_does_not_leak_in():
    matmul = torch.backends.cuda.matmul
    saved = torch.get_float32_matmul_precision()
    a = counts(12)
    want = torch_ops.pearson_device(a, a, device="cpu")
    try:
        torch.set_float32_matmul_precision("high")
        with pearson_precision():
            assert torch.get_float32_matmul_precision() == "highest"
            assert not matmul.allow_tf32
        assert torch.get_float32_matmul_precision() == "high"
        assert torch.equal(torch_ops.pearson_device(a, a, device="cpu"), want)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(saved)


@pytest.mark.parametrize("value,tf32", [("default", True), ("high", False),
                                        ("highest", False)])
def test_precision_knob(monkeypatch, value, tf32):
    monkeypatch.setenv("SEEKR_TPU_MATMUL_PRECISION", value)
    saved = torch.get_float32_matmul_precision()
    with pearson_precision():
        assert torch.backends.cuda.matmul.allow_tf32 is tf32
        assert torch.get_float32_matmul_precision() == ("high" if tf32 else "highest")
    assert torch.get_float32_matmul_precision() == saved


def test_precision_knob_typo_warns_and_uses_float32(monkeypatch):
    import seekr_tpu_torch.ops.precision as precision

    monkeypatch.setenv("SEEKR_TPU_MATMUL_PRECISION", "hihg")
    monkeypatch.setattr(precision, "_warned_invalid", False)
    with pytest.warns(UserWarning, match="not one of"):
        assert precision.tf32_requested() is False


@pytest.mark.parametrize("n_cols", [4096, 3 * 4096 + 5])
def test_long_contractions_are_summed_in_pieces(n_cols):
    # up to GEMM_CHUNK columns one product; past it, 4,096-column pieces added
    # in order (the k = 9 contraction was outside the 1e-4 budget on the card
    # as one cuBLAS product)
    rng = np.random.default_rng(n_cols)
    a = torch.from_numpy(rng.normal(size=(6, n_cols)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(5, n_cols)).astype(np.float32))
    chunk = torch_ops.GEMM_CHUNK
    want = a[:, :chunk] @ b[:, :chunk].T
    for c in range(chunk, n_cols, chunk):
        want = want + a[:, c:c + chunk] @ b[:, c:c + chunk].T
    want = want / torch.tensor(float(n_cols))
    assert torch.equal(torch_ops.matmul_nt(a, b), want)
    exact = (a.double() @ b.double().T) / n_cols
    assert (torch_ops.matmul_nt(a, b).double() - exact).abs().max() < 1e-5


# -- the split TF32 self Gram (ops.pearson.split_gram) ---------------------------

LOW_13 = 0x1FFF
CASES = ["random", "tiny", "subnormal", "zeros", "large"]


def split_case(name):
    """float32 values of one magnitude class, both signs."""
    rng = np.random.default_rng(CASES.index(name))
    if name == "random":
        x = rng.normal(size=4096) * 10.0 ** rng.uniform(-3, 3, 4096)
    elif name == "tiny":  # normal, near the bottom of float32's range
        x = rng.uniform(1, 2, 2048) * 2.0 ** rng.integers(-126, -100, 2048)
    elif name == "subnormal":
        x = rng.integers(1, 2 ** 23, 2048, dtype=np.int64).astype(np.int32).view(np.float32)
    elif name == "zeros":
        x = np.array([0.0, -0.0, 0.0, -0.0])
    else:  # large: up to float32's largest, past TF32's largest
        x = rng.uniform(1, 2, 2048) * 2.0 ** rng.integers(100, 128, 2048)
        x = np.append(np.minimum(x, np.finfo(np.float32).max),
                      [np.finfo(np.float32).max, torch_ops.TF32_MAX,
                       np.nextafter(np.float32(torch_ops.TF32_MAX), np.float32(np.inf))])
    x = np.asarray(x, dtype=np.float32)
    if name != "zeros":
        x = x * rng.choice(np.array([-1, 1], dtype=np.float32), x.size)
    return torch.from_numpy(x)


@pytest.mark.parametrize("case", CASES)
def test_split_halves_are_tf32_values(case):
    hi, lo = torch_ops.split_tf32(split_case(case))
    for half in (hi, lo):
        assert not (half.view(torch.int32) & LOW_13).any()
        assert torch.isfinite(half).all()


@pytest.mark.parametrize("case", CASES)
def test_split_halves_sum_to_the_value_within_2_to_the_minus_22(case):
    # hi is a rounded to 11 significant bits (off by 2^-11 |a| at most), lo the
    # rest rounded the same way (2^-11 of the rest): 2^-22 |a| together.  Where
    # the rest is subnormal, TF32 steps by 2^-136, so the floor is half that.
    a = split_case(case)
    hi, lo = torch_ops.split_tf32(a)
    a64 = a.double()
    miss = (a64 - hi.double() - lo.double()).abs()
    assert (miss <= torch.clamp(2.0 ** -22 * a64.abs(), min=2.0 ** -137)).all()


def nearest_tf32(x):
    """Round to nearest TF32, ties away from zero, in float64: 11 significant
    bits in float32's normal range, a step of 2^-136 below it, clamped to
    TF32's largest."""
    x = x.double()
    step = torch.clamp(2.0 ** (torch.frexp(x).exponent.double() - 11), min=2.0 ** -136)
    r = torch.sign(x) * torch.floor(x.abs() / step + 0.5) * step
    return torch.clamp(r, -torch_ops.TF32_MAX, torch_ops.TF32_MAX).float()


@pytest.mark.parametrize("case", CASES)
def test_round_to_tf32_is_the_nearest_tf32_value(case):
    a = split_case(case)
    got = torch_ops.round_to_tf32(a)
    assert torch.equal(got, nearest_tf32(a))
    assert torch.equal(torch.signbit(got[got == 0]), torch.signbit(a[got == 0]))


def test_round_to_tf32_keeps_nan_and_makes_no_inf():
    nans = torch.tensor([0x7FFFFFFF, -1, 0x7FC00000, 0x7F800001, 0x7F800FFF,
                         0x7F801000, -0x7FF001, 0x7FFFF000], dtype=torch.int32)
    nans = nans.view(torch.float32)
    assert torch.isnan(nans).all()
    assert torch.isnan(torch_ops.round_to_tf32(nans)).all()
    hi, lo = torch_ops.split_tf32(nans)
    assert torch.isnan(hi).all()
    big = split_case("large")
    assert torch.isfinite(torch_ops.round_to_tf32(big)).all()
    assert torch.isfinite(torch.cat(torch_ops.split_tf32(big))).all()


def standardized(seed, m, n):
    return torch_ops.standardize_rows(counts(seed, m=m, n=n), device="cpu")


def test_emulated_split_gram_within_its_derived_bound():
    # a = hi + lo + e with |hi| <= (1 + 2^-11)|a|, |lo| <= (2^-11 + 2^-22)|a|
    # and |e| <= 2^-22 |a| (split_tf32), so
    #   a_i a_j - (hi_i hi_j + hi_i lo_j + lo_i hi_j)
    #     = lo_i lo_j + hi_i e_j + e_i hi_j + lo_i e_j + e_i lo_j + e_i e_j,
    # at most (1 + 2 (1 + 2^-11) + 2^-9) 2^-22 |a_i||a_j| < 3.01 * 2^-22 |a_i||a_j|
    # a column.  Summed: |hi hi^T + X + X^T - a a^T| <= 3.01 * 2^-22 (|a| |a|^T),
    # plus float64's own rounding of the products (~n 2^-53, under 1e-9 here).
    # For standardized rows (|a_i|.|a_j| <= n) that is 7.2e-7 of r.
    a = standardized(13, 48, 4096)
    hi, lo = (h.double() for h in torch_ops.split_tf32(a))
    x = hi @ lo.T
    emulated = hi @ hi.T + x + x.T
    a64 = a.double()
    bound = (3.01 * 2.0 ** -22 + 1e-9) * (a64.abs() @ a64.abs().T)
    assert ((emulated - a64 @ a64.T).abs() <= bound).all()
    assert (emulated - a64 @ a64.T).abs().max() / a.shape[1] < 7.2e-7


@pytest.mark.parametrize("n_cols", [4096, 3 * 4096 + 5])
def test_split_gram_in_float32_within_the_budget(n_cols):
    # the split Gram's own arithmetic on the CPU (the symmetric GEMM's twin: the
    # products in float32, the folds, the pieces, the narrow last piece, the divide
    # of the last launch): r as close to float64 as the fp32 product
    a = standardized(n_cols, 40, n_cols)
    blocks = torch_ops.column_blocks["gram"]
    got = torch_ops.split_gram(a, n=n_cols).double()
    assert torch_ops.column_blocks["gram"] == blocks + len(torch_ops.blocks_of(n_cols))
    a64 = a.double()
    exact = (a64 @ a64.T) / n_cols
    assert (got - exact).abs().max() < 1e-5
    fp32 = torch_ops.matmul_nt(a, a).double()
    assert (got - exact).abs().max() <= 3 * (fp32 - exact).abs().max() + 1e-7


def test_split_gram_nan_cells_are_the_fp32_products():
    # a zero-std row standardizes to NaN; its row and column of r are NaN in
    # both products, and no other cell
    c = counts(14, m=12, n=4096)
    c[3] = 1.0
    c[8, 5] = np.nan
    a = torch_ops.standardize_rows(c, device="cpu")
    split = torch_ops.split_gram(a, a.shape[1])
    plain = torch_ops.gram(a, a)
    assert torch.isnan(plain).any()
    assert torch.equal(torch.isnan(split), torch.isnan(plain))


@pytest.mark.parametrize("value,route", [("high", "fp32"), ("highest", "fp32"),
                                         ("default", "tf32")])
def test_self_gram_on_the_cpu_is_the_plain_product(monkeypatch, value, route):
    # a CPU tensor has no TF32: every setting takes the plain product, as before
    monkeypatch.setenv("SEEKR_TPU_MATMUL_PRECISION", value)
    c = torch.from_numpy(counts(15, n=4096))
    before = dict(torch_ops.gram_routes)
    got = torch_ops.pearson_graph(c)
    assert torch_ops.gram_routes[route] == before[route] + 1
    assert sum(torch_ops.gram_routes.values()) == sum(before.values()) + 1
    a = torch_ops.standardize_rows(c, device="cpu")
    assert torch.equal(got, torch_ops.matmul_nt(a, a))
