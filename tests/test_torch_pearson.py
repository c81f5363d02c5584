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
