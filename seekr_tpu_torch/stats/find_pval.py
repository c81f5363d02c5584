"""P-values for pairwise k-mer Pearson similarities.

Port of ``seekr_tpu/stats/find_pval.py:58-324`` (behavioural parity with
seekr/find_pval.py:70-183): counts + Pearson of two fastas on the device, then
per-cell p-values on the host from either a fitted scipy distribution
(``1 - cdf(r)``) or an empirical background sample (``mean(bkg > r)``).

  * the empirical branch is a sorted ``searchsorted`` (O(log N) per cell,
    float64) instead of the reference's O(N) Python loop per cell, with the
    same values, ties included (``ops.ecdf``);
  * the fitted branch evaluates the cdf over the whole matrix at once
    (``stats.fast_cdf``, bitwise scipy's);
  * the k vs mean/std compatibility check is the reference's intended one
    (upstream find_pval.py:76 has an operator-precedence bug that makes it
    pass vacuously).

The result is a ``LabeledMatrix`` (rows = seq1 headers, columns = seq2
headers) where the reference returns a DataFrame.  Past
``STREAM_CELL_THRESHOLD`` cells with an output path, the matrix is streamed
block by block into the artifacts and never exists whole.  ``data_parallel``
runs the Pearson data-sharded over a device mesh (``parallel``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from seekr_tpu_torch.io.fast_csv import LabeledMatrix
from seekr_tpu_torch.io.stream import (STREAM_CELL_THRESHOLD, ArrayCollector,
                                       StreamingCsvWriter, StreamingNpyWriter,
                                       stream_pearson)
from seekr_tpu_torch.models.counter import KmerCounter
from seekr_tpu_torch.models.pearson import mirror_upper_inplace, pearson
from seekr_tpu_torch.ops.ecdf import SortedBackground
from seekr_tpu_torch.utils.device import resolve_device
from seekr_tpu_torch.utils.profiler import span

_NO_PVAL = "No p value is calculated. The output is None."


def is_float_type(x):
    """Numeric check for fitres entries.

    A deliberate fix of the reference's ``isinstance(x, float) or
    np.isscalar(x)`` (seekr/find_pval.py:56-57), which accepts strings.
    """
    return isinstance(x, (int, float, np.floating, np.integer))


def check_tuple_format(tup):
    """(distribution name, deviance, parameters) -- seekr/find_pval.py:58-64."""
    if len(tup) != 3:
        return False
    return (isinstance(tup[0], str)
            and is_float_type(tup[1])
            and isinstance(tup[2], tuple)
            and all(is_float_type(x) for x in tup[2]))


def check_main_list(main_list):
    return all(check_tuple_format(tup) for tup in main_list)


def equal_nan(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Same shape and values, NaN equal to NaN, decided on the tensors' device
    (only the answer crosses to the host)."""
    if a.shape != b.shape:
        return False
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def _fitted_pval_fn(distname, params):
    def pval_fn(sim):
        from seekr_tpu_torch.stats.fast_cdf import fast_cdf

        cdf_vals = fast_cdf(distname, params, sim)
        if cdf_vals is None:
            from scipy import stats

            cdf_vals = getattr(stats, distname)(*params).cdf(sim)
        # float32 like the reference's np.zeros_like(sim) accumulator
        return (1.0 - cdf_vals).astype(sim.dtype)
    return pval_fn


def _empirical_pval_fn(fitres):
    # sorted once: the streamed mode calls pval_fn per block
    sorted_bkg = SortedBackground(fitres)

    def pval_fn(sim):
        return np.asarray(sorted_bkg.pvals(sim), dtype=sim.dtype)
    return pval_fn


def _pval_fn(fitres, bestfit):
    """The p-value function of ``fitres``, or None after the reference's
    advisory messages when ``fitres``/``bestfit`` are unusable."""
    if isinstance(fitres, list):
        if not check_main_list(fitres):
            print("The format of fitres is wrong.")
            print("fitres should be a list consisting of tuples (string, "
                  "number, tuple of numbers) corresponds to (distribution "
                  "name, deviance, parameters)")
            print("fitres should be the output of find_dist.")
            print(_NO_PVAL)
            return None
        try:
            if float(bestfit) != int(bestfit):  # 1.5 must not truncate
                raise ValueError
            bestfit = int(bestfit)
        except (TypeError, ValueError):
            print(f"bestfit must be an integer between 1 and the number "
                  f"of fitted distributions in fitres ({len(fitres)}), "
                  f"got {bestfit!r}.")
            print(_NO_PVAL)
            return None
        if not 1 <= bestfit <= len(fitres):
            # hardening over the reference, which indexes fitres[bestfit-1]
            # unchecked (bestfit=0 would select the WORST fit)
            print(f"bestfit must be between 1 and the number of fitted "
                  f"distributions in fitres ({len(fitres)}), got {bestfit}.")
            print(_NO_PVAL)
            return None
        distname, _, params = fitres[bestfit - 1]
        return _fitted_pval_fn(distname, params)
    if isinstance(fitres, np.ndarray):
        if fitres.ndim != 1:
            print("The dimension of fitres as a numpy array is wrong. fitres "
                  "should be a 1D numpy array.")
            print("fitres should be the output of find_dist.")
            print(_NO_PVAL)
            return None
        return _empirical_pval_fn(fitres)
    print("fitres should be the output of find_dist. It should be "
          "either a list of distributions or a numpy array.")
    print(_NO_PVAL)
    return None


def find_pval(seq1file, seq2file, mean_path, std_path, k_mer, fitres,
              log2="Log2.post", bestfit=1, outputname=None, progress_bar=True,
              stream=None, npy_out=None, stream_block_rows: int = 4096,
              data_parallel=None, device=None):
    """p-value ``LabeledMatrix`` (rows = seq1 headers, cols = seq2 headers).

    The reference's signature and contract (seekr/find_pval.py:70): None on an
    invalid ``fitres``, with the same advisory messages.  ``progress_bar`` is
    accepted for parity and has no effect (the whole matrix is one vectorized
    call).  ``stream`` forces the streamed mode on or off (None = past
    ``STREAM_CELL_THRESHOLD`` cells when an artifact path is given); streamed,
    the CSV (``outputname``) and .npy (``npy_out``) are written block by block
    and None is returned.  ``device``: where counting and Pearson run
    (``None`` = the first CUDA card).  ``data_parallel`` runs the O(m1*m2)
    Pearson data-sharded over a mesh of that many devices of ``device``'s kind,
    streamed or in memory; a self comparison is mirrored to exact symmetry.
    """
    from seekr_tpu_torch.parallel.mesh import build_mesh_from_flags

    with span("find_pval"):
        device = resolve_device(device)
        mesh = build_mesh_from_flags(data_parallel, device=device)
        meanfile = np.load(mean_path)
        stdfile = np.load(std_path)
        if len(meanfile) != 4 ** k_mer or len(stdfile) != 4 ** k_mer:
            print("k_mer size is not compatible with the normalization mean "
                  "and/or std files.")
            print("Please make sure the normalization mean and std files are "
                  "generated using the same kmer size as specified here in k_mer.")
            print(_NO_PVAL)
            return None

        t1 = KmerCounter(seq1file, mean=mean_path, std=std_path, k=k_mer,
                         log2=log2, silent=True, device=device)
        # self-comparison: one counter, one count pass and ONE tensor object, so
        # pearson standardizes once and mirrors the upper triangle: the p-value
        # matrix is exactly symmetric and takes adj_pval's triu path, as the
        # reference's bitwise-symmetric np.inner output does
        same_file = os.path.realpath(seq1file) == os.path.realpath(seq2file)
        t2 = t1 if same_file else KmerCounter(seq2file, mean=mean_path,
                                              std=std_path, k=k_mer,
                                              log2=log2, silent=True, device=device)
        c1 = t1.get_counts_device()
        c2 = c1 if same_file else t2.get_counts_device()
        if c2 is not c1 and equal_nan(c1, c2):
            # identical content under different names (copies, hardlinks the
            # realpath check missed) is the same comparison; the labels (header2)
            # are kept as parsed, as adj_pval's detector compares them too
            c2 = c1

        # the counters already parsed both fastas
        header1 = [h[1:] for h in t1.headers]
        header2 = [h[1:] for h in t2.headers]
        for name, header in (("seq1file", header1), ("seq2file", header2)):
            if len(header) != len(set(header)):
                print(f"The headers of {name} is not unique.")
                print("Be carefule during further analysis as there are potential "
                      "indexing problems.")

        pval_fn = _pval_fn(fitres, bestfit)
        if pval_fn is None:
            return None

        m1, m2 = len(header1), len(header2)
        do_stream = (stream if stream is not None
                     else (m1 * m2 > STREAM_CELL_THRESHOLD
                           and bool(outputname or npy_out)))
        if do_stream and not (outputname or npy_out):
            # a forced stream with no sink would compute and discard every value
            raise ValueError("find_pval(stream=True) writes artifacts only: "
                             "pass outputname= (csv) and/or npy_out= (.npy)")
        if do_stream:
            return _stream_pvals(c1, c2, pval_fn, header1, header2,
                                 outputname, npy_out, stream_block_rows, device, mesh)

        if mesh is None:
            sim = pearson(c1, c2, device=device)
        else:
            from seekr_tpu_torch.parallel.dist import stream_pearson_sharded

            coll = ArrayCollector()
            # counts2=None on self: one standardize pass, one copy on the mesh
            stream_pearson_sharded(mesh, c1, coll, counts2=None if c2 is c1 else c2,
                                   block_rows=stream_block_rows)
            sim = coll.result()
            if c2 is c1:
                mirror_upper_inplace(sim)  # exact symmetry, as the single-device path
        p_values = pval_fn(sim)
        if npy_out:
            np.save(npy_out, p_values)
        pvals = LabeledMatrix(p_values, header1, header2)
        if outputname:
            pvals.to_csv(f"{outputname}.csv")
        return pvals


class _PvalBlocks:
    """Writer turning each streamed r block into p-values for every sink."""

    def __init__(self, pval_fn, sinks):
        self.pval_fn = pval_fn
        self.sinks = sinks

    def append(self, sim_block):
        p = self.pval_fn(np.asarray(sim_block))
        for s in self.sinks:
            s.append(p)


def _stream_pvals(c1, c2, pval_fn, header1, header2, outputname, npy_out,
                  block_rows, device, mesh=None):
    """Block-wise sim -> p-values -> append: the [m1, m2] matrix never exists.

    Peak host memory is one [block_rows, m2] block; the artifacts' bytes are
    the in-memory path's.  With ``mesh`` the blocks come off the data-sharded
    GEMM.
    """
    m1, m2 = len(header1), len(header2)
    sinks = []
    # sink construction, streaming and the close loop sit inside one
    # discard-on-error envelope: no partial artifact may ever publish
    try:
        if outputname:
            sinks.append(StreamingCsvWriter(f"{outputname}.csv", columns=header2,
                                            row_labels=header1, fmt="%s"))
        if npy_out:
            sinks.append(StreamingNpyWriter(npy_out, (m1, m2), np.float32))
        if mesh is None:
            stream_pearson(c1, c2, _PvalBlocks(pval_fn, sinks), block_rows=block_rows,
                           device=device)
        else:
            from seekr_tpu_torch.parallel.dist import stream_pearson_sharded

            stream_pearson_sharded(mesh, c1, _PvalBlocks(pval_fn, sinks),
                                   counts2=None if c2 is c1 else c2, block_rows=block_rows)
        paths = []
        for s in sinks:
            s.close()
            paths.append(s.path)
    except BaseException:
        for s in sinks:
            s.discard()
        raise
    print(f"p values streamed: {m1} x {m2} matrix written to "
          f"{' and '.join(paths)}.")
    print("The output is None (streamed mode does not materialize the "
          "matrix; load the artifacts instead).")
    return None
