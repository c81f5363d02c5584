"""Fit background distributions to all-pairs k-mer Pearson correlations.

Port of ``seekr_tpu/stats/find_dist.py:41-443`` (behavioural parity with
seekr/find_dist.py:82-294).  The expensive part, the all-pairs Pearson of the
background transcriptome (O(m^2 4^k), m ~13k for the default corpus), runs on
the device as the blocked GEMM, streamed block by block into the upper
triangle (``similarity_triu``: the [m, m] square never exists on the host).
Past ``EXACT_SUBSAMPLE_MAX_POOL`` the subsetting path computes only the sampled
pairs with a device gather-dot (``sample_triu_pairs``).  The scipy MLE fits
stay on the host: they iterate over up to ~100 distributions on a <=100k-value
vector.

Not in this port yet: the fit plot (``plotfit``, the viz slice) and the mesh
arguments (``data_parallel``/``kmer_parallel`` > 1, the multi-GPU slice); both
raise instead of being ignored.  Documented differences from the reference
are seekr_tpu's: ``inputseq='default'`` raises when the bundled mouse vM25
fasta is absent (it is absent upstream too), and fits can run in host
processes (``n_jobs``).
"""

from __future__ import annotations

import os
import warnings

import numpy as np

from seekr_tpu_torch.io.fast_csv import _quote
from seekr_tpu_torch.models.counter import KmerCounter
from seekr_tpu_torch.utils.adj import triu_index_to_ij
from seekr_tpu_torch.utils.device import resolve_device
from seekr_tpu_torch.utils.progress import my_tqdm

# Above this pool size (m(m-1)/2 candidate r-values) the subsetting path
# switches from reference-exact np.random.choice over the materialized triangle
# to index sampling + a device gather-dot of only the sampled pairs.  The
# default keeps the reference's own 13k background (84.5M pool) exact under a
# fixed np.random.seed; it crosses at m ~ 31.6k.
EXACT_SUBSAMPLE_MAX_POOL = 500_000_000

COMMON10 = [
    "cauchy", "chi2", "expon", "exponpow", "gamma",
    "lognorm", "norm", "pareto", "rayleigh", "uniform",
]

# problematic fits excluded upstream (seekr/find_dist.py:113-116)
_EXCLUDED = {"levy_stable", "studentized_range"}

RESULT_COLUMNS = ("distribution_name", "D_statistics", "params")


def _all_scipy_distributions():
    from scipy import stats

    cont = [d for d in dir(stats) if isinstance(getattr(stats, d), stats.rv_continuous)]
    disc = [d for d in dir(stats) if isinstance(getattr(stats, d), stats.rv_discrete)]
    names = [d for d in cont + disc if not d.startswith("_")]
    return [d for d in names if d not in _EXCLUDED]


def _drop_unfittable(names, announce):
    """Remove distributions without a ``.fit`` method (every scipy discrete
    distribution).  The reference filters these too (find_dist.py:139-146) but
    its message lists every requested name; this prints the excluded subset."""
    from scipy import stats

    fittable = [d for d in names if hasattr(getattr(stats, d), "fit")]
    if announce and len(fittable) < len(names):
        print(f"Excluding distributions do not have a 'fit' method: "
              f"{[d for d in names if d not in fittable]}")
    return fittable


def resolve_models(models):
    """'common10' | 'all' | list of scipy.stats names -> list of names."""
    if isinstance(models, str) and models == "common10":
        return list(COMMON10)
    available = _all_scipy_distributions()
    if isinstance(models, str) and models == "all":
        # 'all' includes the discrete families, none of which can be MLE
        # fitted; dropped silently like the reference (find_dist.py:142)
        return _drop_unfittable(available, announce=False)
    if isinstance(models, str):
        # a bare name like 'norm': list(models) would split it into characters
        models = [models]
    requested = list(models)
    valid = [d for d in requested if d in available]
    if len(valid) < len(requested):
        print(
            "Please enter valid distribution names available in scipy.stats. "
            "refer to https://docs.scipy.org/doc/scipy/reference/stats.html"
            "#continuous-distributions"
        )
        print(f"Excluding invalid distributions for fitting: "
              f"{[d for d in requested if d not in valid]}")
    return _drop_unfittable(valid, announce=True)


def _background_counts(inputseq, k_mer=4, log2="Log2.post",
                       save_norm_prefix="bkg", device=None):
    """Normalized count matrix of the background fasta, on ``device``.

    Writes the background normalization vectors as
    ``{prefix}_mean_{k}mers.npy`` / ``{prefix}_std_{k}mers.npy`` into the
    working directory, as the reference does (seekr/find_dist.py:148-153).
    """
    norm_counter = KmerCounter(inputseq, log2=log2, k=k_mer, silent=True, device=device)
    # sets .mean/.std; only the two [4^k] vectors cross to the host
    norm_counter.get_counts_device()
    mean_path = f"{save_norm_prefix}_mean_{k_mer}mers.npy"
    std_path = f"{save_norm_prefix}_std_{k_mer}mers.npy"
    np.save(mean_path, norm_counter.mean)
    np.save(std_path, norm_counter.std)

    # parity quirk: the reference builds this second counter WITHOUT a log2
    # argument (find_dist.py:156), so the counts fed into Pearson always use
    # the default 'Log2.post'
    counter = KmerCounter(inputseq, mean=mean_path, std=std_path, k=k_mer,
                          silent=True, device=device)
    return counter.get_counts_device()


def similarity_triu(counts, block_rows: int = 4096, device=None) -> np.ndarray:
    """Strict upper triangle of the self-Pearson, reduced block by block.

    Blocks stream off the device GEMM into ``io.stream.TriuCollector``, which
    keeps each row's j > i tail: the values of
    ``triu_values(pearson(counts, counts))`` (seekr/find_dist.py:160-163)
    without the [m, m] square on the host.
    """
    from seekr_tpu_torch.io.stream import TriuCollector, stream_pearson

    w = TriuCollector(int(counts.shape[0]))
    stream_pearson(counts, counts, w, block_rows=block_rows, device=device)
    return w.result()


def background_similarity(inputseq, k_mer=4, log2="Log2.post",
                          save_norm_prefix="bkg", device=None):
    """Counts + self-Pearson of a background fasta, upper triangle flattened."""
    counts = _background_counts(inputseq, k_mer=k_mer, log2=log2,
                                save_norm_prefix=save_norm_prefix, device=device)
    return similarity_triu(counts, device=device)


def sample_triu_pairs(counts, subset_size: int, device=None) -> np.ndarray:
    """``subset_size`` r-values sampled uniformly from the triu pool.

    Distinct flat triangle indices are drawn through the global numpy RNG (so
    np.random.seed pins the run), mapped to (i, j) row pairs, and only those
    pairs' correlations are computed on the device (``pearson_pairs``).  The
    draws necessarily differ from the reference's np.random.choice over the
    materialized pool, a regime the reference cannot reach.
    """
    from seekr_tpu_torch.ops.pearson import pearson_pairs

    m = int(counts.shape[0])
    pool = m * (m - 1) // 2
    # rejection loop: O(subset) memory; with pool >> subset (the only regime
    # this path serves) collisions are rare
    seen = set()
    picks = []
    while len(picks) < subset_size:
        for v in np.random.randint(0, pool, size=subset_size - len(picks)).tolist():
            if v not in seen:
                seen.add(v)
                picks.append(v)
    ii, jj = triu_index_to_ij(m, np.asarray(picks, dtype=np.int64))
    return pearson_pairs(counts, ii, jj, device=device)


def _fit_one(name, data, statsmethod, rvs_seed=None):
    """Fit one scipy distribution; returns (name, D, params) or an error str.

    Module-level so ProcessPoolExecutor can pickle it.  ``rvs_seed`` pins the
    mse method's synthetic draw, so n_jobs > 1 reproduces the sequential run.
    """
    from scipy import stats
    from scipy.stats import kstest

    distribution = getattr(stats, name)
    if not hasattr(distribution, "fit"):
        # unreachable through find_dist (resolve_models drops these); a guard
        # for direct fit_distributions callers
        return None
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore")
        try:
            # plain-float params keep the CSV artifact's format the reference's
            params = tuple(float(p) for p in distribution.fit(data))
            if statsmethod == "ks":
                # the family's cdf method, not its name: scipy 1.18 maps the
                # name 'norm' to special.ndtr, which takes no loc/scale, so
                # every norm fit would fail; older scipy resolves the name to
                # this same callable
                D, _ = kstest(data, distribution.cdf, args=params)
            elif statsmethod == "mse":
                synthetic = distribution.rvs(*params, size=len(data),
                                             random_state=rvs_seed)
                D = float(np.mean((data - synthetic) ** 2))
            else:  # aic / bic
                ll = np.sum(distribution.logpdf(data, *params))
                n_params, n = len(params), len(data)
                D = 2 * n_params - 2 * ll if statsmethod == "aic" \
                    else np.log(n) * n_params - 2 * ll
        except Exception as e:  # noqa: BLE001 -- parity: skip the unfittable
            return f"Could not fit {name} because {e}, excluding it from the results"
    return (name, D, params)


def _fit_one_timed(name, data, statsmethod, fit_timeout, rvs_seed=None):
    """_fit_one under a SIGALRM deadline (None/0 = no deadline).

    A timeout surfaces as the same "Could not fit <name> because ..." skip
    message as any other fit failure.  Off the main thread or without SIGALRM
    the fit runs unguarded.
    """
    import signal
    import threading

    if not fit_timeout or not hasattr(signal, "SIGALRM") \
            or threading.current_thread() is not threading.main_thread():
        return _fit_one(name, data, statsmethod, rvs_seed)

    def _raise(signum, frame):
        raise TimeoutError(f"fitting exceeded fit_timeout={fit_timeout}s")

    old = signal.signal(signal.SIGALRM, _raise)
    signal.setitimer(signal.ITIMER_REAL, fit_timeout)
    try:
        return _fit_one(name, data, statsmethod, rvs_seed)
    except TimeoutError as e:
        # the alarm can fire just outside _fit_one's own try: still a skip
        return f"Could not fit {name} because {e}, excluding it from the results"
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def fit_distributions(data, names, statsmethod="ks", progress_bar=False,
                      n_jobs: int = 1, fit_timeout=None):
    """Fit each named scipy distribution to ``data``; score goodness of fit.

    Returns [(name, D, params)] sorted ascending by D (seekr/find_dist.py:
    181-242, including the skip of distributions that fail to fit).
    ``n_jobs > 1`` fans the fits out over spawned processes with the same
    result; ``fit_timeout`` (seconds) bounds each fit, and a timed-out
    distribution is skipped with the usual "Could not fit ..." message.
    """
    if statsmethod not in ("ks", "mse", "aic", "bic"):
        print("Please enter a valid statsmethod: 'ks', 'mse', 'aic', or 'bic'. "
              "Use default 'ks' now.")
        statsmethod = "ks"

    names = list(names)
    # mse draws synthetic samples: one seed per task, drawn here from the
    # global RNG, so parallel == sequential and seeded runs reproduce
    seeds = (np.random.randint(0, 2 ** 31 - 1, size=len(names))
             if statsmethod == "mse" else [None] * len(names))

    if n_jobs > 1:
        import concurrent.futures as cf
        import multiprocessing as mp

        # spawn, not fork: the parent holds torch's thread pools
        ctx = mp.get_context("spawn")
        with cf.ProcessPoolExecutor(max_workers=n_jobs, mp_context=ctx) as pool:
            futures = [pool.submit(_fit_one_timed, name, data, statsmethod,
                                   fit_timeout, seed)
                       for name, seed in zip(names, seeds)]
            iterable = my_tqdm()(futures) if progress_bar else futures
            raw = [f.result() for f in iterable]
    else:
        pairs = list(zip(names, seeds))
        iterable = my_tqdm()(pairs) if progress_bar else pairs
        raw = [_fit_one_timed(name, data, statsmethod, fit_timeout, seed)
               for name, seed in iterable]

    results = []
    for item in raw:
        if item is None:
            continue
        if isinstance(item, str):
            print(item)
            continue
        results.append(item)
    results.sort(key=lambda x: x[1])
    return results


def write_fit_results(path, results) -> None:
    """The bytes of ``pd.DataFrame(results, columns=RESULT_COLUMNS)
    .to_csv(path, index=False)``: the D column as a float64 column (shortest
    repr, NaN empty), the params tuple as its ``str``, csv-minimal quoting."""
    d_values = np.asarray([r[1] for r in results], dtype=np.float64)
    d_cells = d_values.astype(str)
    d_cells[np.isnan(d_values)] = ""
    with open(path, "w", newline="") as fh:
        fh.write(",".join(RESULT_COLUMNS) + "\n")
        for (name, _, params), d in zip(results, d_cells):
            fh.write(f"{_quote(name)},{d},{_quote(params)}\n")


def find_dist(inputseq="default", k_mer=4, log2="Log2.post", models="common10",
              subsetting=True, subset_size=100000, fit_model=True,
              statsmethod="ks", progress_bar=False, plotfit=None,
              outputname=None, n_jobs=1, fit_timeout=None,
              data_parallel=None, kmer_parallel=1,
              exact_subsample_max_pool=EXACT_SUBSAMPLE_MAX_POOL, device=None):
    """Find the best-fitting distribution of background pairwise similarities.

    seekr_tpu's ``find_dist`` (seekr/find_dist.py:82): a list of
    (name, D, params) tuples when ``fit_model`` else the raw r-value array,
    and the optional CSV artifact.  ``n_jobs``/``fit_timeout`` bound the host
    fitting loop; above ``exact_subsample_max_pool`` the subsample comes from
    index sampling + a device gather-dot of only the sampled pairs.
    ``device``: where counting and Pearson run (``None`` = the first CUDA card).
    ``plotfit`` and ``data_parallel``/``kmer_parallel`` > 1 raise: the fit plot
    and the mesh come with later slices of the port.
    """
    if plotfit:
        raise NotImplementedError(
            "find_dist(plotfit=...): the fit plot comes with the port's viz "
            "slice; use seekr_tpu.stats.find_dist for it meanwhile")
    if (data_parallel or 1) > 1 or (kmer_parallel or 1) > 1:
        raise NotImplementedError(
            "find_dist(data_parallel/kmer_parallel > 1): the device mesh comes "
            "with the port's multi-GPU slice")
    device = resolve_device(device)
    if inputseq == "default":
        bundled = os.path.normpath(os.path.join(
            os.path.dirname(os.path.realpath(__file__)), "..", "data",
            "gencode.vM25.lncRNA_transcripts.unique.genesequence_withfullairn.fa"))
        if os.path.exists(bundled):
            print("Using default background sequences: mouse vM25 lncRNA "
                  "unique transcript sequences from GENCODE.")
            inputseq = bundled
        else:
            raise FileNotFoundError(
                "The default mouse vM25 background fasta is not bundled "
                "(it is also absent from the upstream repository). Download "
                "it with seekr_tpu.data.Downloader(...).get_gencode('lncRNA', "
                "species='mouse', release='M25') and pass the path as "
                "inputseq.")

    names = resolve_models(models)
    counts = _background_counts(inputseq, k_mer=k_mer, log2=log2, device=device)
    m = int(counts.shape[0])
    pool = m * (m - 1) // 2

    if subsetting and pool > exact_subsample_max_pool and subset_size < pool:
        # bounded-memory regime: the pool is never materialized
        sim_triu = sample_triu_pairs(counts, subset_size, device=device)
    else:
        sim_triu = similarity_triu(counts, device=device)
        if subsetting:
            if len(sim_triu) > subset_size:
                sim_triu = np.random.choice(sim_triu, size=subset_size,
                                            replace=False)
            else:
                print("subset_size is larger than the actual data size, "
                      "use the actual data size instead")

    if not fit_model:
        if outputname:
            np.savetxt(f"{outputname}.csv", sim_triu, delimiter=",")
        return sim_triu

    if len(names) > 50 and len(sim_triu) > 5_000_000 and not subsetting:
        print("The input sequence count and distribution number for fitting "
              "are both large, subsetting is recommended to save time")

    results = fit_distributions(sim_triu, names, statsmethod=statsmethod,
                                progress_bar=progress_bar, n_jobs=n_jobs,
                                fit_timeout=fit_timeout)
    if outputname:
        write_fit_results(f"{outputname}.csv", results)
    return results
