"""The barplots' data without pandas: counted profiles, column statistics with
pandas' arithmetic, pandas' sort order, and the melted long-form columns of the
words drawn.

seekr_tpu builds a ``pd.DataFrame`` of the counts, reduces its columns
(``df.mean()``, ``df.std()``, ``(df - df.mean()).abs().sum()``), orders them with
``Series.sort_values`` and melts the reordered frame.  pandas holds a float32
frame as one C-contiguous [columns, rows] block and reduces its rows: a float32
sum for the mean and the absolute deviations, a float64 two-pass variance cast
back to float32 for the sample sd (ddof=1).  The same numpy calls on the same
layout give the same bits, so the orders agree even at ties.
``sort_values`` is not stable: it is numpy's quicksort over the keys, reversed
around the sort when descending (pandas' ``nargsort``).  seaborn gets the melted
columns as a dict, which it takes as long-form data.
"""

from __future__ import annotations

import numpy as np


def counted_profiles(inputfile, mean, std, k, log2, device=None):
    """(headers without '>', float32 counts [m, 4^k], k-mer names): the port's
    ``KmerCounter`` on ``device`` (``None`` = the first CUDA card)."""
    from seekr_tpu_torch.models.counter import KmerCounter

    counter = KmerCounter(inputfile, mean=mean, std=std, log2=log2, k=k,
                          silent=True, device=device)
    counter.make_count_file()
    return [h[1:] for h in counter.headers], counter.counts, counter.kmers


def _blocks(counts) -> np.ndarray:
    """The frame's block: columns as contiguous rows."""
    return np.ascontiguousarray(np.asarray(counts).T)


def column_mean(counts) -> np.ndarray:
    """``pd.DataFrame(counts).mean()``."""
    block = _blocks(counts)
    return block.sum(axis=1, dtype=block.dtype) / block.dtype.type(block.shape[1])


def column_sd(counts) -> np.ndarray:
    """``pd.DataFrame(counts).std()``: the sample sd (ddof=1)."""
    block = _blocks(counts)
    n = block.dtype.type(block.shape[1])
    avg = block.sum(axis=1, dtype=np.float64) / n
    var = ((avg[:, None] - block) ** 2).sum(axis=1, dtype=np.float64) / (n - 1)
    return np.sqrt(var.astype(block.dtype))


def abs_deviation_sum(counts) -> np.ndarray:
    """``(df - df.mean()).abs().sum()``: each column's summed |difference from
    the column mean|."""
    counts = np.asarray(counts)
    block = _blocks(np.abs(counts - column_mean(counts)[None, :]))
    return block.sum(axis=1, dtype=block.dtype)


def sort_order(keys, ascending: bool) -> np.ndarray:
    """``Series(keys).sort_values(ascending=...)``'s positions (NaN last)."""
    keys = np.asarray(keys)
    mask = np.isnan(keys)
    idx = np.arange(len(keys))
    values, order = keys[~mask], idx[~mask]
    if not ascending:
        values, order = values[::-1], order[::-1]
    order = order[values.argsort(kind="quicksort")]
    if not ascending:
        order = order[::-1]
    return np.concatenate([order, idx[mask]])


def melt(counts, headers, kmers, order) -> dict:
    """``df[kmers[order]].reset_index().melt(...)`` with the columns renamed
    Sample, Kword, Value: column by column, every row in order."""
    counts = np.asarray(counts)
    order = np.asarray(order)
    return {"Sample": list(headers) * len(order),
            "Kword": [kmers[j] for j in order for _ in headers],
            "Value": counts[:, order].T.ravel()}


def plot_rows(counts, headers, kmers, order, topkmernumber: int) -> dict:
    """The melted rows seaborn draws: the first ``topkmernumber`` words of
    ``order`` for every sequence, or all of them with the reference's message
    when there are fewer.  Only those words are melted: seekr_tpu melts every
    word and keeps the head, which is the same rows."""
    if topkmernumber > len(order):
        print(f"Only {len(order)} kmer words, less than {topkmernumber} words you "
              "want to plot, plot all words")
        return melt(counts, headers, kmers, order)
    return melt(counts, headers, kmers, order[:topkmernumber])
