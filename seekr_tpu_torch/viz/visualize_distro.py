"""Distribution plot of r-values (legacy ``seekr_visualize_distro``).

Port of ``seekr_tpu/viz/visualize_distro.py``, which reconstructs the legacy
1.x capability the reference dropped in its 2.0 rewrite (CHANGELOG 1.3.0, 1.4.0):
load a similarity matrix (``.npy`` or labeled CSV), take its strict upper
triangle when square and symmetric (each pair once, self-correlations
excluded) else every finite value, and save a histogram with summary statistics
in the title.  A ``.npy`` above ``io.stream.STREAM_CELL_THRESHOLD`` cells is
read in bounded memory (``stream_distro_stats``), whose symmetry probe and two
passes are timed as ``distro/symmetry``, ``distro/pass1`` and ``distro/pass2``
(``utils.logging.stage_timer``).  The statistics are host work, callable
without matplotlib.
"""

from __future__ import annotations

import numpy as np

from seekr_tpu_torch.io.stream import STREAM_CELL_THRESHOLD
from seekr_tpu_torch.stats.adj_pval import _tiled_symmetric
from seekr_tpu_torch.stats.stream_adj import _evict, _iter_value_chunks, _tiled_symmetric_mm
from seekr_tpu_torch.utils.adj import get_adj, triu_values
from seekr_tpu_torch.utils.logging import stage_timer
from seekr_tpu_torch.viz.style import ensure_headless_backend, save_figure, setup_fonts


def distro_values(adj, symmetric=None) -> np.ndarray:
    """Finite r-values of a matrix: strict upper triangle when the
    matrix is square and symmetric (5-decimal tolerance, same detector
    as adj_pval — GEMM roundoff must not flip a similarity matrix into
    the double-counting branch), else every cell.  ``symmetric``
    overrides the detection (same contract as the streamed path — the
    flag must mean the same thing at every artifact size)."""
    loaded = get_adj(adj)  # ndarray for .npy, LabeledMatrix for CSV
    mat = np.asarray(getattr(loaded, "values", loaded), dtype=np.float64)
    if mat.ndim != 2:
        raise ValueError("expected a 2D matrix of r-values")
    if symmetric and mat.shape[0] != mat.shape[1]:
        raise ValueError(
            f"symmetric=True needs a square matrix, got {mat.shape} — "
            "the strict-upper-triangle subset of a rectangle would "
            "silently misreport every statistic")
    if symmetric is None:
        symmetric = mat.shape[0] == mat.shape[1] and _tiled_symmetric(mat)
    if symmetric:
        vals = triu_values(mat)
        return vals[np.isfinite(vals)]
    vals = np.ravel(mat)
    return vals[np.isfinite(vals)]


def stream_distro_stats(path, bins=100, fine_bins: int = 1 << 20,
                        chunk_cells: int = 32 << 20, symmetric=None):
    """Bounded-memory histogram + summary stats of a ``.npy`` matrix.

    Two chunked passes over the memmapped artifact (triu values when
    square-and-symmetric, like ``distro_values``): pass 1 accumulates
    min/max/count/sum/sum-of-squares, pass 2 fills the plot histogram
    and a ``fine_bins``-resolution histogram whose cdf crossing gives
    the median to within one fine-bin width (exact rank selection of
    10^10 values is the external-sort problem adj_pval_stream solves —
    a plot title does not warrant it; the title marks it approximate).
    ``symmetric`` overrides the 5-decimal transpose detection (the
    check itself is tiled and bounded, but costs one extra full read of
    the artifact — pass True/False when the caller already knows, like
    adj_pval_stream's flag).  Returns
    (counts, edges, n, mean, sd, median_approx).
    """
    mm = np.load(path, mmap_mode="r")
    if mm.ndim != 2:
        raise ValueError("expected a 2D matrix of r-values")
    if symmetric is None:
        with stage_timer("distro/symmetry"):
            symmetric = mm.shape[0] == mm.shape[1] and _tiled_symmetric_mm(mm)
    elif symmetric and mm.shape[0] != mm.shape[1]:
        raise ValueError(
            f"symmetric=True needs a square matrix, got {mm.shape} — "
            "the strict-upper-triangle subset of a rectangle would "
            "silently misreport every statistic")
    chunk_rows = max(1, int(chunk_cells) // max(1, int(mm.shape[1])))

    n = 0
    total = 0.0
    total_sq = 0.0
    vmin, vmax = np.inf, -np.inf
    with stage_timer("distro/pass1"):
        for vals, _ in _iter_value_chunks(mm, symmetric, chunk_rows):
            v = np.asarray(vals, np.float64)
            v = v[np.isfinite(v)]
            if not v.size:
                continue
            n += v.size
            total += v.sum()
            total_sq += (v * v).sum()
            vmin = min(vmin, v.min())
            vmax = max(vmax, v.max())
            _evict(mm)
    if n == 0:
        return None
    mean = total / n
    sd = float(np.sqrt(max(total_sq / n - mean * mean, 0.0)))

    span = (vmin, vmax if vmax > vmin else vmin + 1.0)
    counts = np.zeros(int(bins), np.int64)
    fine = np.zeros(int(fine_bins), np.int64)
    with stage_timer("distro/pass2"):
        for vals, _ in _iter_value_chunks(mm, symmetric, chunk_rows):
            v = np.asarray(vals, np.float64)
            v = v[np.isfinite(v)]
            if not v.size:
                continue
            counts += np.histogram(v, bins=int(bins), range=span)[0]
            fine += np.histogram(v, bins=int(fine_bins), range=span)[0]
            _evict(mm)
    edges = np.histogram_bin_edges([], bins=int(bins), range=span)
    cdf = np.cumsum(fine)
    mid = np.searchsorted(cdf, (n + 1) // 2)
    fine_edges = np.histogram_bin_edges([], bins=int(fine_bins), range=span)
    median = float((fine_edges[mid] + fine_edges[mid + 1]) / 2)
    return counts, edges, n, float(mean), sd, median


def visualize_distro(adj, outputname="distro", bins=100,
                     xlabelsize=20, ylabelsize=20, xticksize=16,
                     yticksize=16, pformat="pdf", pdpi=300, stream=None,
                     symmetric=None):
    """Histogram of a matrix's r-value distribution.

    Parameters
    ----------
    adj : similarity matrix — ndarray, DataFrame, or ``.npy``/CSV path
    outputname : output path without extension
    bins : histogram bin count
    pformat / pdpi : figure format and resolution (style.py fallback
        rules apply)
    stream : for a ``.npy`` path, accumulate the histogram in bounded
        memory instead of loading the matrix (None = auto above
        ``io.stream.STREAM_CELL_THRESHOLD`` cells — extreme-scale sim
        artifacts from ``seekr_pearson -bo``/``seekr_find_pval -bo``
        cannot be loaded at all); the title's median is then marked
        approximate (one 2^-20-of-range bin wide).  ``stream=True``
        with anything but a ``.npy`` path raises (a labeled CSV cannot
        be histogrammed in bounded memory; convert with -bo first)
        rather than silently loading the whole matrix
    symmetric : skip/override the transpose detection (in streamed mode
        the check costs one full extra read of the artifact); True
        takes the strict upper triangle, False every cell — honored
        identically on the dense and streamed paths

    Returns the finite value array (dense path) or the streamed stats
    tuple ``(counts, edges, n, mean, sd, median)``; None only when no
    plot was produced (no finite values).
    """
    ensure_headless_backend()
    import matplotlib.pyplot as plt

    setup_fonts()
    streamed = None
    is_npy_path = isinstance(adj, str) and adj.endswith(".npy")
    if stream and not is_npy_path:
        raise ValueError(
            "stream=True needs a .npy artifact path (labeled CSVs and "
            "in-memory matrices cannot be histogrammed in bounded "
            "memory; write the matrix with -bo / np.save first)")
    if is_npy_path:
        mm = np.load(adj, mmap_mode="r")
        cells = int(np.prod(mm.shape))
        del mm  # shape probe only: release the mapping
        if stream or (stream is None and cells > STREAM_CELL_THRESHOLD):
            streamed = stream_distro_stats(adj, bins=bins,
                                           symmetric=symmetric)
            if streamed is None:
                print("The input matrix has no finite values. "
                      "No plot is produced.")
                return None

    fig, ax = plt.subplots(figsize=(10, 6))
    if streamed is not None:
        counts, edges, n, mean, sd, median = streamed
        ax.stairs(counts, edges, fill=True, color="#4878CF",
                  edgecolor="white", linewidth=0.3)
        title = (f"n={n}  mean={mean:.4f}  sd={sd:.4f}  "
                 f"median≈{median:.4f}")
        vals = streamed  # distinguishable-from-failure success value
    else:
        vals = distro_values(adj, symmetric=symmetric)
        if vals.size == 0:
            print("The input matrix has no finite values. "
                  "No plot is produced.")
            plt.close(fig)
            return None
        ax.hist(vals, bins=int(bins), color="#4878CF", edgecolor="white",
                linewidth=0.3)
        title = (f"n={vals.size}  mean={vals.mean():.4f}  "
                 f"sd={vals.std():.4f}  median={np.median(vals):.4f}")
    ax.set_xlabel("r-value", fontsize=xlabelsize)
    ax.set_ylabel("count", fontsize=ylabelsize)
    ax.tick_params(axis="x", labelsize=xticksize)
    ax.tick_params(axis="y", labelsize=yticksize)
    ax.set_title(title, fontsize=xlabelsize)
    fig.tight_layout()
    save_figure(outputname, pformat, pdpi)
    plt.close(fig)
    return vals
