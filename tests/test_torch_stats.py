"""The port's statistics chain against seekr_tpu's, on the CPU.

Same inputs, made from a seed with numpy, through both packages in one
process (seekr_tpu's jax on the CPU, the port with ``device="cpu"``).
Tolerances, each stated where it is held:

  * ``multipletests``, ``adj_pval`` (given the same input), the ECDF on the
    host and ``fast_cdf``: bitwise;
  * ``pearson_pairs``: 1e-5 absolute (float32 row dots in another order);
  * ``find_dist(fit_model=False)``: the same length, values within 1e-4;
    fitted parameters within 1e-4 relative;
  * ``find_pval``: empirical p-values equal except in cells whose r lies
    within 1e-5 of a background value; fitted p-values within 1e-4; the self
    path exactly symmetric.

Every test that runs find_dist works in its own directory: it writes
``bkg_{mean,std}_{k}mers.npy`` into the working directory.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from seekr_tpu.ops import ecdf as jax_ecdf
from seekr_tpu.ops.pearson import pearson_pairs as jax_pearson_pairs
from seekr_tpu.stats import adj_pval as jax_adj_pval
from seekr_tpu.stats import find_dist as jax_find_dist
from seekr_tpu.stats import find_pval as jax_find_pval
from seekr_tpu.stats.multitest import multipletests as jax_multipletests
from seekr_tpu_torch.io.fast_csv import LabeledMatrix
from seekr_tpu_torch.io.fasta import write_fasta
from seekr_tpu_torch.models.counter import KmerCounter
from seekr_tpu_torch.models.pearson import pearson
from seekr_tpu_torch.ops import ecdf
from seekr_tpu_torch.ops.pearson import pearson_pairs
from seekr_tpu_torch.stats import adj_pval, find_dist, find_pval, multipletests
from seekr_tpu_torch.stats.fast_cdf import fast_cdf
from seekr_tpu_torch.stats.find_dist import fit_distributions

# the module: the package exports the function under its name
find_pval_mod = importlib.import_module("seekr_tpu_torch.stats.find_pval")
CPU = "cpu"
METHODS = ["bonferroni", "sidak", "holm-sidak", "holm", "simes-hochberg",
           "hommel", "fdr_bh", "fdr_by", "fdr_tsbh", "fdr_tsbky"]
FAST_MODELS = ["norm", "expon", "rayleigh", "uniform"]
K = 3


def random_fasta(path, m, seed, lo=150, hi=900):
    rng = np.random.default_rng(seed)
    seqs = ["".join(rng.choice(list("ACGT"), size=int(rng.integers(lo, hi))))
            for _ in range(m)]
    write_fasta(str(path), [f"s{seed}_{i}" for i in range(m)], seqs)
    return str(path)


@pytest.fixture
def corpus(tmp_path, monkeypatch):
    """A 60-transcript background, a 12 x 25 query/target pair; cwd = tmp_path."""
    monkeypatch.chdir(tmp_path)
    return {"bkg": random_fasta(tmp_path / "bkg.fa", 60, 1),
            "q": random_fasta(tmp_path / "q.fa", 12, 2),
            "t": random_fasta(tmp_path / "t.fa", 25, 3), "dir": tmp_path}


def pvalues_with_ties(rng, n):
    p = rng.random(n) ** 3
    p[rng.integers(0, n, n // 5)] = p[0]  # ties
    p[rng.integers(0, n, n // 20)] = 0.05
    p[:3] = (0.0, 1.0, p[5])
    return p


@pytest.mark.parametrize("nan", [False, True], ids=["finite", "nan"])
@pytest.mark.parametrize("method", METHODS)
def test_multipletests_bitwise(method, nan):
    p = pvalues_with_ties(np.random.default_rng(len(method)), 400).reshape(20, 20)
    if nan:
        p[3, 4] = np.nan
    got = multipletests(p, alpha=0.05, method=method)
    want = jax_multipletests(p, alpha=0.05, method=method)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1], equal_nan=True)
    assert got[1].shape == p.shape
    assert got[2:] == want[2:]


@pytest.mark.parametrize("is_sorted,returnsorted", [(True, False), (False, True), (True, True)])
def test_multipletests_sorted_forms_bitwise(is_sorted, returnsorted):
    p = np.sort(pvalues_with_ties(np.random.default_rng(9), 300))
    for method in ("holm", "fdr_bh", "hommel"):
        got = multipletests(p, method=method, is_sorted=is_sorted, returnsorted=returnsorted)
        want = jax_multipletests(p, method=method, is_sorted=is_sorted,
                                 returnsorted=returnsorted)
        assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_multipletests_aliases_empty_and_errors():
    p = pvalues_with_ties(np.random.default_rng(3), 50)
    assert np.array_equal(multipletests(p, method="fdr_i")[1], multipletests(p)[1])
    reject, corrected, sidak, bonf = multipletests(np.empty(0))
    assert reject.shape == corrected.shape == (0,) and np.isnan(sidak) and np.isnan(bonf)
    with pytest.raises(ValueError, match="method not recognized"):
        multipletests(p, method="nope")


def test_pearson_pairs_vs_seekr_tpu():
    rng = np.random.default_rng(4)
    counts = rng.random((40, 64)).astype(np.float32)
    ii = rng.integers(-40, 40, 500)
    jj = rng.integers(0, 40, 500)
    got = pearson_pairs(counts, ii, jj, chunk=128, device=CPU)
    want = jax_pearson_pairs(counts, ii, jj)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    full = pearson(counts, counts, device=CPU)
    np.testing.assert_allclose(got, full[ii, jj], rtol=0, atol=1e-5)
    assert pearson_pairs(counts, [], [], device=CPU).shape == (0,)
    for bad in ([40], [-41]):
        with pytest.raises(IndexError, match="outside"):
            pearson_pairs(counts, bad, [0], device=CPU)
        with pytest.raises(IndexError, match="outside"):
            jax_pearson_pairs(counts, bad, [0])


def test_ecdf_bitwise_vs_seekr_tpu():
    rng = np.random.default_rng(5)
    bkg = rng.normal(size=1000).astype(np.float32)
    bkg[::97] = np.nan
    sim = rng.normal(size=(30, 20)).astype(np.float32)
    sim[0, :5] = bkg[1:6]  # exact ties
    got = ecdf.SortedBackground(bkg).pvals(sim)
    assert np.array_equal(got, jax_ecdf.empirical_pvals(bkg, sim))
    assert np.array_equal(ecdf.empirical_pvals(bkg, sim), got)
    # the reference's own formula: NaNs are not greater, N keeps them
    assert np.array_equal(got[0], [np.mean(bkg > r) for r in sim[0].astype(np.float64)])

    finite = np.sort(bkg[~np.isnan(bkg)])
    dev = ecdf.ecdf_sf(torch.as_tensor(finite), torch.as_tensor(sim), n_total=len(bkg))
    want = jax_ecdf.ecdf_sf(jnp.asarray(finite), jnp.asarray(sim), n_total=len(bkg))
    assert dev.dtype == torch.float32
    # the device form divides in float32: the same exceedance counts, and
    # values within one float32 ulp (XLA may multiply by the reciprocal)
    np.testing.assert_array_equal(np.rint(dev.numpy().astype(np.float64) * len(bkg)),
                                  np.rint(got * len(bkg)))
    np.testing.assert_allclose(dev.numpy(), np.asarray(want), rtol=1.2e-7, atol=0)


def edge_case_null_and_r(rng, null_dtype, sim_dtype):
    """A null with NaNs, repeats, +-0.0 and infinities, and r that ties it
    exactly, sits on +-0.0 and holds NaN rows (zero-variance rows)."""
    bkg = rng.normal(size=4000).astype(null_dtype)
    bkg[::97] = np.nan
    bkg[1:40:3] = bkg[0]
    bkg[50:60] = 0.0
    bkg[60:70] = -0.0
    bkg[70], bkg[71] = np.inf, -np.inf
    sim = rng.normal(size=(30, 20)).astype(sim_dtype)
    bkg[100:110] = bkg[100:110].astype(np.float32)  # values r can take in either dtype
    sim[0, :10] = bkg[100:110]  # exact ties with the null's values
    sim[1, :4] = (0.0, -0.0, bkg[0], np.float32(bkg[200]))
    sim[2] = np.nan
    sim[3, 3] = np.inf
    return bkg, sim


@pytest.mark.parametrize("sim_dtype", [np.float32, np.float64])
@pytest.mark.parametrize("null_dtype", [np.float32, np.float64])
def test_device_sorted_background_is_the_host_ones_bits(null_dtype, sim_dtype):
    bkg, sim = edge_case_null_and_r(np.random.default_rng(7), null_dtype, sim_dtype)
    want = ecdf.SortedBackground(bkg).pvals(sim).astype(sim.dtype)
    before = dict(ecdf.evaluations)
    dev = ecdf.DeviceSortedBackground(bkg, torch.device(CPU))
    assert dev.n_total == len(bkg)  # the NaNs stay in the denominator
    assert dev.finite.dtype == torch.from_numpy(bkg).dtype
    got = dev.pvals(torch.as_tensor(sim))
    assert got.dtype == sim.dtype and got.tobytes() == want.tobytes()
    assert (got[2] == 0).all()  # NaN r: past every value
    assert ecdf.evaluations == {"device": before["device"] + 1, "host": before["host"]}
    # find_pval's empirical function takes the same path for r given as a tensor
    assert find_pval_mod._empirical_pval_fn(bkg)(torch.as_tensor(sim)).tobytes() \
        == want.tobytes()


def test_cpu_find_pval_counts_host_evaluations(corpus):
    np.random.seed(8)
    bkg = find_dist(corpus["bkg"], k_mer=K, subset_size=500, fit_model=False, device=CPU)
    vectors = (f"bkg_mean_{K}mers.npy", f"bkg_std_{K}mers.npy")
    before = dict(ecdf.evaluations)
    got = find_pval(corpus["q"], corpus["t"], *vectors, K, bkg, device=CPU)
    assert ecdf.evaluations == {"device": before["device"], "host": before["host"] + 1}
    want = ecdf.SortedBackground(bkg).pvals(pearson(
        *[KmerCounter(f, mean=vectors[0], std=vectors[1], k=K, silent=True,
                      device=CPU).get_counts() for f in (corpus["q"], corpus["t"])],
        device=CPU)).astype(np.float32)
    assert got.values.tobytes() == want.tobytes()


@pytest.mark.parametrize("name", ["norm", "expon", "rayleigh", "uniform", "gamma", "lognorm"])
def test_fast_cdf_bitwise_vs_scipy(name):
    rng = np.random.default_rng(6)
    data = rng.random(500) * 0.5 + 0.1
    params = tuple(float(p) for p in getattr(scipy.stats, name).fit(data))
    x = rng.normal(size=(40, 30)).astype(np.float32)
    x[0, 0] = np.nan
    got = fast_cdf(name, params, x)
    assert got is not None
    assert np.array_equal(got, getattr(scipy.stats, name)(*params).cdf(x), equal_nan=True)
    assert fast_cdf("beta", (2.0, 3.0, 0.0, 1.0), x) is None


def test_find_dist_empirical_vs_seekr_tpu(corpus, tmp_path):
    np.random.seed(0)
    want = jax_find_dist(corpus["bkg"], k_mer=K, subsetting=True, subset_size=500,
                         fit_model=False)
    want_vectors = (np.load(f"bkg_mean_{K}mers.npy"), np.load(f"bkg_std_{K}mers.npy"))
    np.random.seed(0)
    got = find_dist(corpus["bkg"], k_mer=K, subsetting=True, subset_size=500,
                    fit_model=False, outputname="rvalues", device=CPU)
    assert got.shape == want.shape == (500,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(np.loadtxt("rvalues.csv", delimiter=","), got, rtol=0, atol=0)
    for path, vec in zip((f"bkg_mean_{K}mers.npy", f"bkg_std_{K}mers.npy"), want_vectors):
        np.testing.assert_allclose(np.load(path), vec, rtol=1e-4, atol=1e-5)
    # without subsetting: the whole upper triangle
    full = find_dist(corpus["bkg"], k_mer=K, subsetting=False, fit_model=False, device=CPU)
    assert full.shape == (60 * 59 // 2,)


def test_find_dist_sampled_pairs_vs_seekr_tpu(corpus):
    # a pool above the exact-subsample limit: only the sampled pairs are computed
    kw = dict(k_mer=K, subsetting=True, subset_size=300, fit_model=False,
              exact_subsample_max_pool=100)
    np.random.seed(1)
    want = jax_find_dist(corpus["bkg"], **kw)
    np.random.seed(1)
    got = find_dist(corpus["bkg"], device=CPU, **kw)
    assert got.shape == want.shape == (300,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_find_dist_fitted_vs_seekr_tpu(corpus, tmp_path):
    np.random.seed(2)
    want = jax_find_dist(corpus["bkg"], k_mer=K, models=FAST_MODELS, subset_size=800)
    np.random.seed(2)
    got = find_dist(corpus["bkg"], k_mer=K, models=FAST_MODELS, subset_size=800,
                    outputname="fitres", device=CPU)
    assert [r[0] for r in got] == [r[0] for r in want]
    for (_, d_got, p_got), (_, d_want, p_want) in zip(got, want):
        np.testing.assert_allclose(p_got, p_want, rtol=1e-4)
        np.testing.assert_allclose(d_got, d_want, rtol=1e-4)
    assert (tmp_path / "fitres.csv").read_text().startswith(
        "distribution_name,D_statistics,params\n")


@pytest.mark.parametrize("statsmethod", ["ks", "mse", "aic", "bic"])
def test_fit_distributions_vs_seekr_tpu(statsmethod):
    from seekr_tpu.stats.find_dist import fit_distributions as jax_fit

    data = np.random.default_rng(7).normal(size=1000)
    np.random.seed(8)
    got = fit_distributions(data, ["norm", "uniform", "expon"], statsmethod=statsmethod)
    np.random.seed(8)
    assert got == jax_fit(data, ["norm", "uniform", "expon"], statsmethod=statsmethod)


def test_ks_fit_passes_the_cdf_not_its_name(monkeypatch):
    # scipy 1.18's kstest maps the name 'norm' to special.ndtr, which takes no
    # loc/scale: a fit that passed the name would be skipped there
    real = scipy.stats.kstest

    def kstest_without_names(rvs, cdf, args=(), **kwargs):
        if isinstance(cdf, str):
            raise TypeError("ndtr() takes from 1 to 2 positional arguments but 3 were given")
        return real(rvs, cdf, args=args, **kwargs)

    monkeypatch.setattr(scipy.stats, "kstest", kstest_without_names)
    data = np.random.default_rng(9).normal(size=1000)
    got = fit_distributions(data, ["norm", "expon"])
    assert sorted(r[0] for r in got) == ["expon", "norm"]
    # D is the plain two-sided KS statistic of the fitted cdf (tolerance 1e-12)
    x = np.sort(data)
    n = len(x)
    for name, d, params in got:
        cdf = getattr(scipy.stats, name).cdf(x, *params)
        plain = max((np.arange(1, n + 1) / n - cdf).max(), (cdf - np.arange(n) / n).max())
        assert abs(d - plain) <= 1e-12


def test_fit_timeout_skips_a_hung_fit(monkeypatch, capsys):
    import time

    data = np.random.default_rng(7).normal(size=1000)

    def slow_fit(*args, **kwargs):
        time.sleep(10)
        return (0.0, 1.0)

    monkeypatch.setattr(type(scipy.stats.norm), "fit", slow_fit)
    t0 = time.perf_counter()
    results = fit_distributions(data, ["norm", "uniform"], fit_timeout=0.5)
    assert time.perf_counter() - t0 < 5
    assert [r[0] for r in results] == ["uniform"]
    assert "Could not fit norm because" in capsys.readouterr().out


def near_tie_mask(sim, bkg, tol=1e-5):
    """Cells whose r lies within ``tol`` of some background value."""
    sorted_bkg = np.sort(bkg.astype(np.float64))
    r = sim.astype(np.float64)
    lo = np.searchsorted(sorted_bkg, r - tol, side="left")
    hi = np.searchsorted(sorted_bkg, r + tol, side="right")
    return hi > lo


def test_find_pval_vs_seekr_tpu(corpus):
    np.random.seed(3)
    bkg = jax_find_dist(corpus["bkg"], k_mer=K, subset_size=1000, fit_model=False)
    fitres = fit_distributions(bkg, FAST_MODELS)
    vectors = (f"bkg_mean_{K}mers.npy", f"bkg_std_{K}mers.npy")
    q, t = corpus["q"], corpus["t"]

    got = find_pval(q, t, *vectors, K, bkg, device=CPU)
    want = jax_find_pval(q, t, *vectors, K, bkg)
    assert isinstance(got, LabeledMatrix) and got.shape == (12, 25)
    assert got.index == list(want.index) and got.columns == list(want.columns)
    assert got.values.dtype == np.float32
    counts = [KmerCounter(f, mean=vectors[0], std=vectors[1], k=K, silent=True,
                          device=CPU).get_counts() for f in (q, t)]
    ties = near_tie_mask(pearson(*counts, device=CPU), bkg)
    assert np.array_equal(got.values[~ties], want.to_numpy()[~ties])

    got = find_pval(q, t, *vectors, K, fitres, bestfit=2, device=CPU)
    want = jax_find_pval(q, t, *vectors, K, fitres, bestfit=2)
    np.testing.assert_allclose(got.values, want.to_numpy(), rtol=0, atol=1e-4)

    # self path: one counter, one tensor, exactly symmetric
    got = find_pval(t, t, *vectors, K, fitres, outputname="self", device=CPU)
    assert np.array_equal(got.values, got.values.T)
    want = jax_find_pval(t, t, *vectors, K, fitres)
    np.testing.assert_allclose(got.values, want.to_numpy(), rtol=0, atol=1e-4)


def test_find_pval_streamed_equals_in_memory(corpus, tmp_path):
    np.random.seed(4)
    bkg = find_dist(corpus["bkg"], k_mer=K, subset_size=500, fit_model=False, device=CPU)
    vectors = (f"bkg_mean_{K}mers.npy", f"bkg_std_{K}mers.npy")
    whole = find_pval(corpus["q"], corpus["t"], *vectors, K, bkg, outputname="mem",
                      npy_out="mem.npy", device=CPU)
    streamed = find_pval(corpus["q"], corpus["t"], *vectors, K, bkg, outputname="str",
                         npy_out="str.npy", stream=True, stream_block_rows=5, device=CPU)
    assert streamed is None
    assert (tmp_path / "str.csv").read_bytes() == (tmp_path / "mem.csv").read_bytes()
    np.testing.assert_array_equal(np.load("str.npy"), whole.values)
    assert sorted(p.name for p in tmp_path.iterdir() if p.suffix == ".part") == []
    with pytest.raises(ValueError, match="writes artifacts only"):
        find_pval(corpus["q"], corpus["t"], *vectors, K, bkg, stream=True, device=CPU)


def test_find_pval_identical_copies_take_the_self_path(corpus, tmp_path):
    copy = tmp_path / "t_copy.fa"
    copy.write_bytes((tmp_path / "t.fa").read_bytes())
    np.random.seed(5)
    bkg = find_dist(corpus["bkg"], k_mer=K, subset_size=500, fit_model=False, device=CPU)
    got = find_pval(corpus["t"], str(copy), f"bkg_mean_{K}mers.npy",
                    f"bkg_std_{K}mers.npy", K, bkg, device=CPU)
    assert np.array_equal(got.values, got.values.T)


@pytest.mark.parametrize("fitres,bestfit,message", [
    ([("norm", 0.1, (0.0, "x"))], 1, "The format of fitres is wrong."),
    ([("norm", 0.1, (0.0, 1.0))], 2, "bestfit must be between 1 and"),
    ([("norm", 0.1, (0.0, 1.0))], 1.5, "bestfit must be an integer"),
    (np.zeros((2, 2)), 1, "The dimension of fitres as a numpy array is wrong."),
    ("bkg.csv", 1, "either a list of distributions or a numpy array"),
])
def test_find_pval_guards_match_seekr_tpu(corpus, capsys, fitres, bestfit, message):
    np.save("m.npy", np.zeros(4 ** K))
    np.save("s.npy", np.ones(4 ** K))
    args = (corpus["q"], corpus["t"], "m.npy", "s.npy", K, fitres)
    assert jax_find_pval(*args, bestfit=bestfit) is None
    want = capsys.readouterr().out
    assert find_pval(*args, bestfit=bestfit, device=CPU) is None
    got = capsys.readouterr().out
    assert got == want and message in got and "The output is None." in got


def test_find_pval_k_mismatch(corpus, capsys):
    np.save("m.npy", np.zeros(16))
    np.save("s.npy", np.ones(16))
    assert find_pval(corpus["q"], corpus["t"], "m.npy", "s.npy", K, [], device=CPU) is None
    assert "not compatible" in capsys.readouterr().out


@pytest.mark.parametrize("symmetric", [True, False], ids=["triu", "full"])
def test_adj_pval_bitwise_vs_seekr_tpu(tmp_path, symmetric, capsys):
    import pandas as pd

    rng = np.random.default_rng(8)
    p = pvalues_with_ties(rng, 30 * 30).reshape(30, 30).astype(np.float32)
    labels = [f"r{i}" for i in range(30)]
    if symmetric:
        p = np.triu(p) + np.triu(p, 1).T
        p[np.diag_indices(30)] = rng.random(30)  # the diagonal never decides
    cols = labels if symmetric else [f"c{j}" for j in range(30)]
    for method in ("fdr_bh", "bonferroni", "hommel"):
        got = adj_pval(LabeledMatrix(p, labels, cols), method,
                       outputname=str(tmp_path / "t"))
        want = jax_adj_pval(pd.DataFrame(p, index=labels, columns=cols), method,
                            outputname=str(tmp_path / "j"))
        assert np.array_equal(got.values, want.to_numpy(), equal_nan=True)
        assert got.index == labels and got.columns == cols
        assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    out = capsys.readouterr().out
    assert ("is a symmetric matrix" in out) == symmetric
    assert np.isnan(got.values[np.tril_indices(30)]).all() == symmetric


@pytest.mark.parametrize("symmetric", [True, False], ids=["triu", "full"])
def test_adj_pval_native_paths_bitwise(monkeypatch, symmetric, capsys):
    # past the native gates (2,048 rows, 65,536 values): the tiled symmetric
    # test, the triangle gather and fill and the fused FDR run in C++; they
    # equal seekr_tpu's (the same C++) and the port's numpy paths, bit for bit
    import pandas as pd

    rng = np.random.default_rng(9)
    m = 2100
    p = np.round(rng.random((m, m)) ** 2, 6)
    if symmetric:
        p = np.triu(p) + np.triu(p, 1).T
    labels = [f"r{i}" for i in range(m)]
    monkeypatch.delenv("SEEKR_TPU_HOST_SORT", raising=False)
    got = adj_pval(LabeledMatrix(p, labels, labels), "fdr_bh").values
    want = jax_adj_pval(pd.DataFrame(p, index=labels, columns=labels), "fdr_bh").to_numpy()
    assert got.tobytes() == want.tobytes()
    monkeypatch.setenv("SEEKR_TPU_HOST_SORT", "numpy")
    numpy_path = adj_pval(LabeledMatrix(p, labels, labels), "fdr_bh").values
    assert got.tobytes() == numpy_path.tobytes()
    assert ("is a symmetric matrix" in capsys.readouterr().out) == symmetric


def test_adj_pval_rejects_other_inputs_and_asymmetric_labels(capsys):
    assert adj_pval(np.zeros((3, 3)), "fdr_bh") is None
    assert "is not a dataframe" in capsys.readouterr().out
    p = np.full((3, 3), 0.5)
    adj_pval(LabeledMatrix(p, ["a", "b", "c"], ["a", "b", "x"]), "fdr_bh")
    assert "not a symmetric matrix" in capsys.readouterr().out


def test_entry_points_refuse_what_later_slices_bring(corpus, monkeypatch):
    # a mesh of cards needs that many cards (the CPU mesh needs device="cpu"),
    # and fails before any counting
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"requested 4 devices \(data_parallel=2 x "
                                         r"kmer_parallel=2\), have 1"):
        find_dist(corpus["bkg"], plotfit="plot", data_parallel=2, kmer_parallel=2,
                  device="cuda")
    with pytest.raises(ValueError, match="requested 2 devices"):
        find_pval(corpus["q"], corpus["t"], "m.npy", "s.npy", K, [], data_parallel=2,
                  device="cuda")
    assert not list(corpus["dir"].glob("bkg_*.npy"))


@pytest.mark.parametrize("dp,kp", [(4, 1), (2, 2)], ids=["dp4", "dp2-kp2"])
def test_find_dist_and_find_pval_on_a_mesh(corpus, dp, kp):
    one = find_dist(corpus["bkg"], k_mer=K, fit_model=False, subsetting=False, device=CPU)
    got = find_dist(corpus["bkg"], k_mer=K, fit_model=False, subsetting=False,
                    data_parallel=dp, kmer_parallel=kp, device=CPU)
    want = jax_find_dist(corpus["bkg"], k_mer=K, fit_model=False, subsetting=False,
                         data_parallel=dp, kmer_parallel=kp)
    assert got.shape == one.shape == (60 * 59 // 2,)
    np.testing.assert_allclose(got, one, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)

    vectors = ("bkg_mean_3mers.npy", "bkg_std_3mers.npy")
    background = np.sort(got)
    for q, t in ((corpus["q"], corpus["t"]), (corpus["t"], corpus["t"])):
        mesh = find_pval(q, t, *vectors, K, got, data_parallel=dp, device=CPU).values
        alone = find_pval(q, t, *vectors, K, got, device=CPU).values
        ref = jax_find_pval(q, t, *vectors, K, got, data_parallel=dp).to_numpy()
        np.testing.assert_allclose(mesh, alone, rtol=0, atol=1e-6)
        counts = [KmerCounter(f, mean=vectors[0], std=vectors[1], k=K, silent=True,
                              device=CPU).get_counts() for f in (q, t)]
        r = pearson(*counts, device=CPU).astype(np.float64)
        ties = (np.searchsorted(background, r + 1e-5, side="right")
                > np.searchsorted(background, r - 1e-5, side="left"))
        assert np.array_equal(mesh[~ties], ref[~ties])  # equal away from ties
    assert np.array_equal(mesh, mesh.T)  # the self path mirrors: exactly symmetric


def test_entry_points_need_a_card_unless_cpu_is_asked(corpus, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        find_dist(corpus["bkg"], k_mer=K, fit_model=False)
    np.save("m.npy", np.zeros(4 ** K))
    np.save("s.npy", np.ones(4 ** K))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        find_pval(corpus["q"], corpus["t"], "m.npy", "s.npy", K, np.zeros(5))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pearson_pairs(np.ones((3, 4), np.float32), [0], [1])
    with pytest.raises(FileNotFoundError, match="not bundled"):
        find_dist("default", device=CPU)

