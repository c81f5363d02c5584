"""Normalization of count matrices.

Port of ``seekr_tpu/ops/normalize.py:28-93``, in the reference pipeline's order
(seekr/kmer_counts.py:194-209):

    raw counts-per-kb
    -> (Log2.pre)  counts = log2(counts + 1)
    -> center      counts -= mean  (column mean if computed)
    -> standardize counts /= std   (column POPULATION std of the centered matrix)
    -> (Log2.post) counts += |global min|; counts = log2(counts + 1)

A zero-std column gives NaN or inf, and Log2.post's global ``min`` then spreads
NaN over the whole matrix, as in seekr_tpu and the reference.

The chain runs over column blocks of ``ops.pearson.GEMM_CHUNK`` columns on one
buffer: every step but the shift is column-wise, and the shift is the min of
the blocks' minima (NaN-propagating, as one ``min``).  So past one block (k >= 7)
no temporary is wider than one block, where the whole chain took some ten
[m, 4^k] temporaries.  ``column_blocks["normalize"]`` counts the blocks the
chain ran: one at k <= 6.

On a card the chain's buffer (``counts`` handed over, else its copy) takes the
fused route where the kernels take it (``ops/epilogue_cuda.takes``): per block
one column-statistics launch (the mean and std in float64, and the running
minimum of the standardized values for the shift), then per block one launch of
the chain's elementwise steps in place.  Each element is the chain's float32
arithmetic on float64-accurate statistics, so it can differ from the torch chain
in the last bits (given statistics give the chain's bits); ``routes`` counts each
call's route.  A CPU tensor is the torch chain, bit for bit.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from seekr_tpu_torch.ops import epilogue_cuda
from seekr_tpu_torch.ops.math import accurate_log2
from seekr_tpu_torch.ops.pearson import blocks_of
from seekr_tpu_torch.utils.profiler import span

LOG2_PRE = "Log2.pre"
LOG2_POST = "Log2.post"
LOG2_NONE = "Log2.none"
LOG2_MODES = (LOG2_PRE, LOG2_POST, LOG2_NONE)

column_blocks = {"normalize": 0}
routes = {"fused": 0, "torch": 0}


def check_log2_mode(log2_mode: str) -> None:
    if log2_mode not in LOG2_MODES:
        raise ValueError("log2 must be one of ['Log2.pre', 'Log2.post', 'Log2.none']")


def _columns(block: torch.Tensor, mean, std, log2_mode: str):
    """The chain's column-wise steps, up to the Log2.post shift, in place on
    ``block`` (some columns of the chain's buffer).  Returns (mean_or_None,
    std_or_None)."""
    if log2_mode == LOG2_PRE:
        accurate_log2(block + 1.0, out=block)

    if mean is not False:
        mean = block.mean(dim=0) if mean is None else mean.to(torch.float32)
        block.sub_(mean)
    else:
        mean = None

    if std is not False:
        # population std (correction=0), as jnp.std and numpy's default
        std = block.std(dim=0, correction=0) if std is None else std.to(torch.float32)
        block.div_(std)
    else:
        std = None
    return mean, std


def normalize_graph(counts: torch.Tensor, mean, std, log2_mode: str, inplace: bool = False):
    """The normalize chain on a device tensor.

    ``mean``/``std``: ``None`` computes the column statistic, ``False`` skips the
    step, a tensor is used as given (flat ``[4^k]``).  Returns
    (normalized, mean_or_None, std_or_None); a computed statistic has the
    shape of one row (``counts.shape[1:]``) at one block, and is flat past it.
    ``counts`` is never modified unless ``inplace`` hands it over: the chain
    runs on one buffer, ``counts`` when handed over, else one copy of it.  On a
    card that buffer takes the fused kernels where they take it.
    """
    check_log2_mode(log2_mode)
    with span("normalize"):
        x = counts.to(torch.float32)
        if not inplace and x is counts:
            x = x.clone(memory_format=torch.contiguous_format)
        shape = x.shape
        n_cols = math.prod(shape[1:])
        blocks = blocks_of(n_cols)
        column_blocks["normalize"] += len(blocks)
        stat_shape = shape[1:] if len(blocks) == 1 else (n_cols,)
        if epilogue_cuda.takes(x, mean, std):
            routes["fused"] += 1
            work = fused_chain(x.view(shape[0], n_cols), blocks, mean, std, log2_mode)
            return x, _whole(mean, [work.mean], stat_shape), _whole(std, [work.std], stat_shape)
        routes["torch"] += 1
        x = x.reshape(shape[0], n_cols)
        means, stds, minima = [], [], []
        for cols in blocks:
            block = x[:, cols]
            block_mean, block_std = _columns(block, _cut(mean, cols), _cut(std, cols), log2_mode)
            means.append(block_mean)
            stds.append(block_std)
            if log2_mode == LOG2_POST:
                minima.append(block.min())
        if log2_mode == LOG2_POST:
            shift = torch.stack(minima).min().abs()  # a NaN in any block carries
            for cols in blocks:
                block = x[:, cols]
                accurate_log2(block + shift + 1.0, out=block)
        return x.view(shape), _whole(mean, means, stat_shape), _whole(std, stds, stat_shape)


def fused_chain(x: torch.Tensor, blocks: list, mean, std, log2_mode: str,
                engine=epilogue_cuda.Normalize):
    """The fused route on the ``[m, n]`` buffer ``x``, in place: each block's
    column statistics in order (the shift needs every block's minimum), then
    each block's elementwise steps.  ``engine`` is the kernels' launcher, or
    its plain twin ``epilogue_cuda.NormalizePlain`` on any device.  Returns
    the engine, whose ``mean``/``std`` are the flat statistics used."""
    work = engine(x, blocks, mean, std, pre=log2_mode == LOG2_PRE, post=log2_mode == LOG2_POST)
    if work.needs_stats:
        for index, cols in enumerate(blocks):
            work.stats(index, cols)
    if work.needs_apply:
        for cols in blocks:
            work.apply(cols)
    return work


def _cut(v, cols: slice):
    """Columns ``cols`` of a given statistic; ``None`` and ``False`` pass."""
    return v if v is None or v is False else v.reshape(-1)[cols]


def _whole(given, parts: list, shape):
    """A statistic as the chain returns it: computed, the blocks' parts joined
    in ``shape``; given, as float32; skipped, None."""
    if given is None:
        return (parts[0] if len(parts) == 1 else torch.cat(parts)).view(shape)
    return None if given is False else given.to(torch.float32)


def normalize_counts(counts: torch.Tensor, *, log2_mode: str = LOG2_POST,
                     mean=True, std=True
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Normalize a raw count matrix (a tensor; the result stays on its device).

    ``mean``/``std`` follow the reference contract: ``True`` computes the column
    statistic from the data, ``False`` skips the step, an array (numpy or tensor)
    is the provided vector.

    Returns (normalized_counts, mean_or_None, std_or_None).
    """
    def arg(v):
        if v is True:
            return None
        if v is False:
            return False
        return torch.as_tensor(v, device=counts.device)

    return normalize_graph(counts, arg(mean), arg(std), log2_mode)


def normalize_counts_segmented(counts: torch.Tensor, seg_ids, n_segments: int, *,
                               log2_mode: str = LOG2_POST, mean, std) -> torch.Tensor:
    """Normalize independent row segments of one matrix in one pass.

    Port of ``seekr_tpu/ops/normalize.py:96-146``, for request coalescing
    (``serve.py``): several queries' rows are counted and normalized as one
    batch, but each segment gets the Log2.post shift of its own rows.  The min
    of the row mins is the same float as one global min (``min`` never rounds)
    and the adds keep ``normalize_graph``'s order, so each segment's rows are
    bitwise what ``normalize_counts`` gives that segment alone.  A segment
    holding a NaN gets a NaN shift, as ``min`` spreads it there.

    ``mean``/``std`` must be provided vectors: computed statistics over a
    coalesced batch would mix requests.  ``seg_ids`` maps each row to its
    segment in ``[0, n_segments)``; empty segments are harmless.
    """
    check_log2_mode(log2_mode)
    if mean is True or std is True or mean is False or std is False:
        raise ValueError("normalize_counts_segmented requires provided "
                         "mean/std vectors (got computed/skipped)")
    dev = counts.device
    counts = counts.to(torch.float32)
    if log2_mode == LOG2_PRE:
        counts = accurate_log2(counts + 1.0)
    counts = counts - torch.as_tensor(mean, device=dev).to(torch.float32)
    counts = counts / torch.as_tensor(std, device=dev).to(torch.float32)
    if log2_mode == LOG2_POST:
        seg = torch.as_tensor(seg_ids, device=dev).to(torch.int64)
        row_min = counts.amin(dim=1)  # NaN-propagating
        nan_row = torch.isnan(row_min)
        # the NaN of a segment is carried apart: scatter_reduce's amin is not
        # documented to propagate NaN on every device
        seg_min = torch.zeros(n_segments, dtype=torch.float32, device=dev).scatter_reduce(
            0, seg, row_min.masked_fill(nan_row, float("inf")), "amin", include_self=False)
        seg_nan = torch.zeros(n_segments, dtype=torch.float32, device=dev).index_add_(
            0, seg, nan_row.to(torch.float32)) > 0
        shift = seg_min.masked_fill(seg_nan, float("nan")).abs()
        counts = accurate_log2(counts + shift[seg][:, None] + 1.0)
    return counts
