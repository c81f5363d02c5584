"""The FDR pair's device route (``stats.multitest._fdr_torch``) on the CPU.

``_fdr_torch`` is written for any torch device; here it runs on CPU tensors and
is held bitwise, on the float64 bits, to ``multipletests``' host routes: numpy
(``SEEKR_TPU_HOST_SORT=numpy``) and the C++ library (``=native``).  The route
decision (``_fdr_device``) and the ``fdr_routes`` counter are tested here too;
the route itself on a card is ``test_torch_multitest_card.py``'s.
"""

import numpy as np
import pytest
import torch

from seekr_tpu.stats import adj_pval as jax_adj_pval
from seekr_tpu_torch.io.fast_csv import LabeledMatrix
from seekr_tpu_torch.stats import adj_pval, multitest
from seekr_tpu_torch.stats.multitest import _fdr_device, _fdr_torch, multipletests

FDR = ["fdr_bh", "fdr_by"]
CPU = torch.device("cpu")


def ecdf_pvalues(n, dtype, seed=0):
    """ECDF-like p on a grid of 1/N (N about n/4, so many ties), skewed towards 0
    so that many are rejected, with 0.0 and 1.0 included."""
    rng = np.random.default_rng(seed)
    grid = max(n // 4, 1)
    p = np.floor(rng.random(n) ** 3 * (grid + 1)) / grid
    p[: min(n, 2)] = (0.0, 1.0)[: min(n, 2)]
    return np.minimum(p, 1.0).astype(dtype)


def host_route(monkeypatch, p, method, mode):
    monkeypatch.setenv("SEEKR_TPU_HOST_SORT", mode)
    reject, corrected, *_ = multipletests(p, method=method, device="cpu")
    return reject, corrected


def assert_bitwise(got, want):
    reject, corrected = got
    assert corrected.dtype == np.float64
    assert corrected.view(np.int64).tobytes() == want[1].view(np.int64).tobytes()
    assert np.array_equal(reject, want[0])


def force_device_route(monkeypatch):
    """The device route on CPU tensors: ``_fdr_device`` answers the CPU."""
    monkeypatch.setattr(multitest, "_fdr_device", lambda device, n, itemsize: CPU)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("method", FDR)
@pytest.mark.parametrize("n", [1, 2, 3, 65_535, 65_536, 1_000_003])
def test_fdr_torch_bitwise_host_routes(monkeypatch, n, method, dtype):
    p = ecdf_pvalues(n, dtype, seed=n)
    reject, corrected = _fdr_torch(torch.from_numpy(p), 0.05, by=method == "fdr_by")
    got = reject.numpy(), corrected.numpy()
    assert_bitwise(got, host_route(monkeypatch, p, method, "numpy"))
    assert_bitwise(got, host_route(monkeypatch, p, method, "native"))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("method", FDR)
def test_fdr_torch_rejects_up_to_a_tie_group(monkeypatch, method, dtype):
    # numpy's last rejected sorted p ends its tie group, so the unstable sort
    # rejects the same hypotheses; ties straddle the threshold here
    rng = np.random.default_rng(3)
    p = np.repeat(np.linspace(0.0, 0.2, 40), 2000)[rng.permutation(80_000)].astype(dtype)
    reject, corrected = _fdr_torch(torch.from_numpy(p), 0.05, by=method == "fdr_by")
    want = host_route(monkeypatch, p, method, "numpy")
    assert 0 < want[0].sum() < len(p)
    assert_bitwise((reject.numpy(), corrected.numpy()), want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("method", FDR)
def test_nan_leaves_the_device_route_to_numpy(monkeypatch, method, dtype):
    p = ecdf_pvalues(70_000, dtype, seed=5)
    p[[7, 70]] = np.nan
    assert _fdr_torch(torch.from_numpy(p), 0.05) is None
    want = host_route(monkeypatch, p, method, "numpy")
    monkeypatch.delenv("SEEKR_TPU_HOST_SORT")
    force_device_route(monkeypatch)
    before = dict(multitest.fdr_routes)
    got = multipletests(p, method=method)[:2]
    assert_bitwise(got, want)
    assert np.isnan(got[1]).all()
    assert multitest.fdr_routes["device"] == before["device"]
    assert multitest.fdr_routes["numpy"] == before["numpy"] + 1


def test_signed_zero_and_infinities_match_numpy(monkeypatch):
    p = ecdf_pvalues(70_000, np.float64, seed=6)
    p[[3, 30, 300]] = -0.0
    p[[4, 40]] = (np.inf, -np.inf)
    reject, corrected = _fdr_torch(torch.from_numpy(p), 0.05)
    assert_bitwise((reject.numpy(), corrected.numpy()),
                   host_route(monkeypatch, p, "fdr_bh", "numpy"))


def test_prefix_min_is_exact_across_rows():
    x = torch.from_numpy(np.random.default_rng(4).random(3 * 1024 * 1024 + 77))
    want = np.minimum.accumulate(x.numpy())
    assert multitest._prefix_min(x).numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("symmetric", [True, False], ids=["triu", "full"])
def test_adj_pval_on_cpu_and_device_route_are_todays_bits(monkeypatch, symmetric, capsys):
    # past the native gates; device="cpu" keeps seekr_tpu's bits, and the
    # device route (on CPU tensors here) gives the same
    import pandas as pd

    rng = np.random.default_rng(10)
    m = 400
    p = (np.floor(rng.random((m, m)) ** 2 * 5000) / 5000).astype(np.float32)
    if symmetric:
        p = np.triu(p) + np.triu(p, 1).T
    labels = [f"r{i}" for i in range(m)]
    want = jax_adj_pval(pd.DataFrame(p, index=labels, columns=labels), "fdr_bh").to_numpy()
    on_cpu = adj_pval(LabeledMatrix(p, labels, labels), "fdr_bh", device="cpu").values
    assert on_cpu.tobytes() == want.tobytes()
    force_device_route(monkeypatch)
    before = multitest.fdr_routes["device"]
    routed = adj_pval(LabeledMatrix(p, labels, labels), "fdr_bh").values
    assert multitest.fdr_routes["device"] == before + 1
    assert routed.tobytes() == want.tobytes()
    assert ("is a symmetric matrix" in capsys.readouterr().out) == symmetric


def test_route_decision():
    big, f32 = 1 << 20, 4
    assert _fdr_device(None, big, f32) is None or torch.cuda.is_available()
    assert _fdr_device("cpu", big, f32) is None
    assert _fdr_device(CPU, big, f32, free_bytes=big * 100) is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            _fdr_device("cuda", big, f32, free_bytes=big * 100)


def test_route_decision_thresholds_without_a_card(monkeypatch):
    # a stand-in for CUDA, so the size and memory gates run on any machine
    monkeypatch.setattr(multitest, "resolve_device", lambda device: torch.device(device))
    cuda = torch.device("cuda", 0)
    n, f32 = multitest._NATIVE_SORT_MIN, 4
    need = n * (f32 + multitest._DEVICE_BYTES_PER_VALUE)
    assert _fdr_device(cuda, n, f32, free_bytes=need) == cuda
    assert _fdr_device(cuda, n - 1, f32, free_bytes=need) is None
    assert _fdr_device(cuda, n, f32, free_bytes=need - 1) is None
    assert _fdr_device(cuda, n, 8, free_bytes=need) is None  # float64 p needs more
    assert _fdr_device("cpu", n, f32, free_bytes=need) is None


@pytest.mark.parametrize("case", ["sorted", "returnsorted", "holm"])
def test_host_methods_and_forms_skip_the_device_route(monkeypatch, case):
    monkeypatch.setattr(multitest, "_fdr_device", lambda *a: pytest.fail("route asked"))
    p = ecdf_pvalues(70_000, np.float64, seed=7)
    kwargs = {"sorted": {"is_sorted": True}, "returnsorted": {"returnsorted": True},
              "holm": {"method": "holm"}}[case]
    if case == "sorted":
        p = np.sort(p)
    before = dict(multitest.fdr_routes)
    multipletests(p, **kwargs)
    assert multitest.fdr_routes["device"] == before["device"]


def test_fdr_routes_count_each_route(monkeypatch):
    p = ecdf_pvalues(70_000, np.float32, seed=8)
    counts = multitest.fdr_routes
    before = dict(counts)
    host_route(monkeypatch, p, "fdr_bh", "numpy")
    host_route(monkeypatch, p, "fdr_by", "native")
    host_route(monkeypatch, np.sort(p), "fdr_bh", "native")  # unsorted form, sorted data
    multipletests(np.sort(p), method="fdr_bh", is_sorted=True, device="cpu")  # native scan
    monkeypatch.delenv("SEEKR_TPU_HOST_SORT")
    force_device_route(monkeypatch)
    multipletests(p, method="fdr_by")
    assert {k: counts[k] - before[k] for k in counts} == {"device": 1, "native": 3, "numpy": 1}
