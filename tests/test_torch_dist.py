"""The port's clustering pdist (``ops.dist``) against seekr_tpu's and scipy's, on
the CPU.

Tolerances: within 1e-5 absolute and 1e-6 relative of seekr_tpu's
``pdist_device`` (both float32 Gram products, XLA's and torch's; the squared
euclidean distances of these rows reach ~100, where one float32 ulp is 7.6e-6,
so a few ulps of rounding order pass 1e-5 absolute) and within rtol 1e-4 / atol
1e-5 of scipy's
float64 pdist (``tests/test_dist_ops.py``'s budget), NaN where scipy has NaN.
Below the size threshold ``pdist_auto`` is scipy's exact pdist, bit for bit;
where the card was asked for and fails, it raises instead of running scipy.
"""

import numpy as np
import pytest
from scipy.spatial.distance import pdist

from seekr_tpu.ops import dist as jax_dist
from seekr_tpu_torch.ops import dist

CPU = "cpu"


def profiles(seed, rows=24, cols=40):
    """Seeded rows with a constant one (NaN under correlation) and a zero one
    (NaN under cosine)."""
    x = np.random.default_rng(seed).normal(size=(rows, cols))
    x[3] = 1.25
    x[7] = 0.0
    return x


@pytest.mark.parametrize("metric", dist.DEVICE_METRICS)
def test_pdist_device_matches_seekr_tpu_and_scipy(metric):
    x = profiles(0)
    got = dist.pdist_device(x, metric=metric, device=CPU)
    want = jax_dist.pdist_device(x, metric=metric)
    with np.errstate(invalid="ignore", divide="ignore"):
        exact = pdist(x, metric=metric)
    assert got.dtype == np.float64 and got.shape == exact.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5, equal_nan=True)
    np.testing.assert_allclose(got, exact, rtol=1e-4, atol=1e-5, equal_nan=True)
    if metric in ("correlation", "cosine"):
        assert np.isnan(got).any()  # the constant and the zero rows


def test_pdist_device_on_a_similarity_matrix():
    a = np.random.default_rng(1).random((50, 50))
    sim = (a + a.T) / 2
    np.testing.assert_allclose(dist.pdist_device(sim, "correlation", device=CPU),
                               pdist(sim, "correlation"), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("forced", [None, "device", "scipy", "DEVICE", "other"])
def test_use_device_pdist_matches_seekr_tpu(monkeypatch, forced):
    if forced is None:
        monkeypatch.delenv("SEEKR_TPU_PDIST", raising=False)
    else:
        monkeypatch.setenv("SEEKR_TPU_PDIST", forced)
    shapes = [(10, 10), (100, 100), (1448, 4096), (1449, 4096), (13000, 4096),
              (4096, 13000), (2048, 2048)]
    for rows, cols in shapes:
        for metric in (*dist.DEVICE_METRICS, "cityblock", "hamming"):
            assert dist.use_device_pdist(rows, cols, metric) == \
                jax_dist.use_device_pdist(rows, cols, metric), (rows, cols, metric)
    # 1,449 k=6 profiles are the first to cross 2^33 flops
    assert dist.use_device_pdist(1449, 4096, "correlation") == (forced != "scipy")
    assert dist.use_device_pdist(1448, 4096, "correlation") == (forced in ("device", "DEVICE"))


def test_unknown_metric_raises():
    with pytest.raises(ValueError, match="no device formulation"):
        dist.pdist_device(np.zeros((3, 3)), metric="cityblock", device=CPU)
    with pytest.raises(ValueError, match="2-D"):
        dist.pdist_device(np.zeros(3), metric="correlation", device=CPU)


def test_pdist_auto_routes_by_size_and_metric(monkeypatch):
    x = profiles(3, rows=30, cols=20)[8:]
    monkeypatch.delenv("SEEKR_TPU_PDIST", raising=False)
    assert np.array_equal(dist.pdist_auto(x, "correlation", device=CPU),
                          pdist(x, "correlation"))  # small: scipy, exact
    monkeypatch.setenv("SEEKR_TPU_PDIST", "device")
    np.testing.assert_allclose(dist.pdist_auto(x, "correlation", device=CPU),
                               pdist(x, "correlation"), rtol=1e-4, atol=1e-5)
    assert np.array_equal(dist.pdist_auto(x, "cityblock", device=CPU),
                          pdist(x, "cityblock"))  # no GEMM form: scipy


def test_pdist_auto_raises_where_seekr_tpu_falls_back(monkeypatch):
    import scipy.spatial.distance as ssd

    def broken(*args, **kwargs):
        raise RuntimeError("the Gram product failed")

    def scipy_called(*args, **kwargs):
        raise AssertionError("pdist_auto fell back to scipy")

    monkeypatch.setenv("SEEKR_TPU_PDIST", "device")
    monkeypatch.setattr(dist, "distance_matrix", broken)
    monkeypatch.setattr(ssd, "pdist", scipy_called)
    with pytest.raises(RuntimeError, match="the Gram product failed"):
        dist.pdist_auto(profiles(4), "correlation", device=CPU)
