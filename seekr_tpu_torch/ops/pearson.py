"""All-pairs Pearson correlation as a float32 GEMM.

Port of ``seekr_tpu/ops/pearson.py``.  Semantics follow the reference
(seekr/pearson.py:32-44): optionally row-standardize both matrices (per-row mean
and POPULATION std), then ``r = inner(c1, c2) / n_cols``.  The GEMM is
``torch.matmul`` -- seekr_tpu leaves it to XLA outside any kernel -- under
``pearson_precision()``, which keeps it in full float32.

The self Gram of ``pearson_graph`` on a card is, under the default precision
(``ops/precision.py``), a split-precision product on the tensor cores, the
counterpart of seekr_tpu's bf16x3 ``HIGH``: the operand is split into TF32
halves ``a = hi + lo`` (``split_tf32``) and ``a @ a.T`` is taken as
``hi @ hi.T + X + X.T`` with ``X = hi @ lo.T``, in TF32 products
(``split_gram``).  ``gram_routes`` counts the self Grams by route.  On that
route the row standardization and the split are fused where the kernels take
the buffer (``ops/epilogue_cuda.py``): each row's moments in float64 (one read),
then each column block standardized and split straight into the Gram's TF32
halves, the standardized operand never written; ``standardize_routes`` counts
the standardizations by route (``fused``, ``torch``).

Past ``GEMM_CHUNK`` columns (k >= 7) the row standardization and the Gram run
over column blocks of that width: the row statistics are summed block by block
and applied in place, and the Gram adds one product a block, so no step holds
more than one block's temporaries.  ``column_blocks`` counts the blocks each
ran (``"standardize"``, ``"gram"``): one each at k <= 6.

For outputs too large for one buffer, ``pearson_blocked`` streams row blocks of
the left operand (``io/stream.stream_pearson``) into a host array.
``pearson_pairs`` computes only selected (i, j) pairs: a row gather and a
row-wise multiply-sum, for the sampled background of find_dist.
"""

from __future__ import annotations

import math
from functools import partial

import numpy as np
import torch

from seekr_tpu_torch.ops import epilogue_cuda
from seekr_tpu_torch.ops.precision import matmul_precision, pearson_precision
from seekr_tpu_torch.utils.device import resolve_device
from seekr_tpu_torch.utils.profiler import span


def as_float32(x, device: torch.device) -> torch.Tensor:
    """numpy or tensor input -> float32 tensor on ``device`` (no copy if it is one)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)


def divide(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x / n`` as an IEEE divide: with a Python number CUDA multiplies by 1/n."""
    return x / torch.tensor(float(n), dtype=x.dtype, device=x.device)


def _row_standardize(c: torch.Tensor, inplace: bool = False) -> torch.Tensor:
    """Each row centred by its mean and divided by its population std.

    Axis 0 = rows (sequences); every trailing axis is feature data, so an
    unflattened [m, n_hi, n_lo] count tensor standardizes like its flat view.
    ``inplace`` hands ``c`` over to be overwritten.  Past one column block the
    row sums of the blocks are added in float64, and the centring and the
    division run block by block on one buffer: ``c`` when handed over, else a
    copy.
    """
    standardize_routes["torch"] += 1
    feat = tuple(range(1, c.dim()))
    x = c.to(torch.float32)
    owned = inplace or x is not c
    blocks = blocks_of(math.prod(x.shape[1:]))
    column_blocks["standardize"] += len(blocks)
    if len(blocks) == 1:
        mean = x.mean(dim=feat, keepdim=True)
        x = x.sub_(mean) if owned else x - mean
        # population std (correction=0): torch's default is the unbiased one
        return x.div_(x.std(dim=feat, keepdim=True, correction=0))
    shape = x.shape
    if not owned:
        x = x.clone(memory_format=torch.contiguous_format)
    x = x.reshape(shape[0], -1)
    total = torch.zeros(shape[0], dtype=torch.float64, device=x.device)
    for cols in blocks:
        total.add_(x[:, cols].sum(dim=1))
    mean = (total / x.shape[1]).to(torch.float32)[:, None]
    total.zero_()
    for cols in blocks:
        total.add_(x[:, cols].sub_(mean).square().sum(dim=1))
    std = (total / x.shape[1]).sqrt_().to(torch.float32)[:, None]
    for cols in blocks:
        x[:, cols].div_(std)
    return x.view(shape)


# Columns of one float32 partial product.  A longer contraction is summed in
# pieces of this width, the k = 6 width: on an H100, one cuBLAS product over the
# 262,144 columns of k = 9 was 6.5e-4 from float64, outside the 1e-4 budget
# (chip_smoke.py phase 11 measures both ways).  The row standardization and the
# normalize chain run in column blocks of the same width.
GEMM_CHUNK = 4096

column_blocks = {"standardize": 0, "gram": 0}
gram_routes = {"split": 0, "fp32": 0, "tf32": 0}
standardize_routes = {"fused": 0, "torch": 0}

# float32 keeps 13 mantissa bits more than TF32's 10: adding half of the lowest
# kept bit and clearing the 13 rounds to nearest, ties away from zero (PTX's
# cvt.rna.tf32.f32); the largest TF32 value, so a finite value never rounds to inf
TF32_HALF_ULP = 1 << 12
TF32_MASK = -(1 << 13)
TF32_MAX = (2 - 2 ** -10) * 2.0 ** 127

# Columns one TF32 product of the split Gram's large term ``hi hi^T`` sums
# before its total is added to the rest in float32 (``addmm_``).  The tensor
# cores' float32 sums are not rounded to nearest: on sums of one sign (the
# diagonal, r near 1) their error grows in proportion to this width (and 10x
# less off the diagonal, where terms cancel): on the H100, over the
# 13,000 x 4,096 operand of the k = 6 forward, r's largest error from float64
# was 2.9e-5 at 4,096 columns (outside the 2.5e-5 check), 7.5e-6 at 1,024 and
# 3.6e-6 at 512 (float32's SGEMM 3.8e-6), at 3.2, 4.7 and 6.0 ms for the term.
TF32_SUM_COLUMNS = 512


def blocks_of(n_cols: int) -> list:
    """The ``GEMM_CHUNK``-wide column slices of ``n_cols`` columns, in order
    (one, the whole width, up to ``GEMM_CHUNK``)."""
    return [slice(c, c + GEMM_CHUNK) for c in range(0, max(n_cols, 1), GEMM_CHUNK)]


def gram(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b.T`` in float32, contracted in ``GEMM_CHUNK``-column pieces."""
    blocks = blocks_of(a.shape[1])
    column_blocks["gram"] += len(blocks)
    with span("pearson.gram"), pearson_precision():
        out = None
        for cols in blocks:
            piece = a[:, cols] @ b[:, cols].T
            out = piece if out is None else out.add_(piece)
        return out


def matmul_nt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b.T / n_cols`` in float32 -- the one Pearson GEMM recipe."""
    return divide(gram(a, b), a.shape[1])


def round_to_tf32(x: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """``x`` rounded to the nearest TF32 value (ties away from zero), as float32
    whose low 13 mantissa bits are zero; into ``out`` (not ``x`` itself) if given.

    A finite value past TF32's largest rounds down to it, never to inf.  NaN
    stays NaN (CUDA's NaN, 0x7fffffff, would carry into the sign and read -0);
    +-inf reads NaN too, as a split operand's row would anyway (``inf - hi``).
    """
    y = torch.clamp(x, -TF32_MAX, TF32_MAX, out=out)
    y.view(torch.int32).add_(TF32_HALF_ULP).bitwise_and_(TF32_MASK)
    # + x * 0: zero where x is finite, NaN where it is not
    return y.addcmul_(x, torch.zeros((), dtype=x.dtype, device=x.device))


def split_tf32(a: torch.Tensor, hi: torch.Tensor | None = None,
               lo: torch.Tensor | None = None):
    """``(hi, lo)``, each TF32-exact, with ``|a - hi - lo| <= max(2^-22 |a|,
    2^-137)``: ``hi`` is ``a`` rounded to TF32 (2^-11 of ``|a|`` at most), ``lo``
    the rest ``a - hi`` rounded in turn (2^-11 of the rest; 2^-137, half TF32's
    subnormal step, where the rest is subnormal).  ``hi`` and ``lo``, where
    given, are scratch of ``a``'s shape to write into."""
    hi = round_to_tf32(a, out=hi)
    return hi, round_to_tf32(a - hi, out=lo)


def _add_hi_hi(out: torch.Tensor | None, hi: torch.Tensor) -> torch.Tensor:
    """``out + hi @ hi.T`` (``out`` None: 0), ``TF32_SUM_COLUMNS`` columns a product."""
    for c in range(0, hi.shape[1], TF32_SUM_COLUMNS):
        part = hi[:, c:c + TF32_SUM_COLUMNS]
        out = part @ part.T if out is None else out.addmm_(part, part.T)
    return out


def split_gram(a: torch.Tensor, halves=None) -> torch.Tensor:
    """``a @ a.T`` as TF32 products on the tensor cores, fp32's error class.

    With ``a = hi + lo`` (``split_tf32``), ``a a^T = hi hi^T + hi lo^T + lo hi^T
    + lo lo^T``; every TF32 x TF32 product is exact in float32, and only
    ``lo lo^T`` (2^-22 of the whole) is dropped.  The two cross terms are
    ``X + X^T`` with ``X = hi lo^T``, so the Gram is ``X + X^T`` (out of place)
    plus ``hi hi^T`` (``addmm_``, beta 1), the latter ``TF32_SUM_COLUMNS``
    columns a product.  Past ``GEMM_CHUNK`` columns each piece is split into
    the same scratch, and ``X`` and the ``hi hi^T`` sum gather every piece's
    products; ``X + X^T`` is added once at the end.

    ``halves(cols, hi, lo)`` writes the halves of the columns ``cols`` into the
    scratch ``hi`` and ``lo`` and returns them: by default ``split_tf32`` of
    ``a[:, cols]``; the fused route hands the kernel that standardizes the raw
    rows and splits them in one pass (``a`` is then the unstandardized buffer).
    """
    if halves is None:
        def halves(cols, hi, lo):
            return split_tf32(a[:, cols], hi, lo)
    blocks = blocks_of(a.shape[1])
    column_blocks["gram"] += len(blocks)
    with span("pearson.gram"), pearson_precision(tf32=True):
        hi = lo = x = out = None
        for cols in blocks:
            width = len(range(a.shape[1])[cols])
            if hi is None or hi.shape[1] != width:  # one scratch pair a width
                hi, lo = (torch.empty((a.shape[0], width), dtype=a.dtype, device=a.device)
                          for _ in range(2))
            hi, lo = halves(cols, hi, lo)
            if len(blocks) == 1:
                x = hi @ lo.T
                return _add_hi_hi(x + x.T, hi)
            x = hi @ lo.T if x is None else x.addmm_(hi, lo.T)
            out = _add_hi_hi(out, hi)
        return out.add_(x).add_(x.T)


def gram_route(a: torch.Tensor) -> str:
    """The self Gram's route: ``split``, the split TF32 product, on a card under
    the default precision (``high``); else ``fp32`` (``highest``, and any CPU
    tensor, which has no TF32) or ``tf32`` (``default``)."""
    precision = matmul_precision()
    if precision == "default":
        return "tf32"
    return "split" if precision == "high" and a.is_cuda else "fp32"


def self_gram(a: torch.Tensor) -> torch.Tensor:
    """``a @ a.T`` of one operand, by the route ``gram_routes`` counts
    (``gram_route``): ``split_gram``, else ``gram(a, a)`` in float32 or TF32."""
    route = gram_route(a)
    gram_routes[route] += 1
    return split_gram(a) if route == "split" else gram(a, a)


def pearson_graph(c: torch.Tensor, inplace: bool = False) -> torch.Tensor:
    """Self-Pearson of one count tensor: row-standardize + self Gram / n.

    Equivalent to ``pearson_device(c, c)``; accepts the unflattened 3-D count
    tensor too.  ``inplace`` hands ``c`` over to the row standardization.  On
    the split route, where the kernels take the buffer, the standardization
    and the split are fused (``fused_pearson``) and ``c`` is only read.
    """
    if gram_route(c) == "split":
        x = c.to(torch.float32).reshape(c.shape[0], -1)
        if epilogue_cuda.takes(x):
            return fused_pearson(x)
    c = _row_standardize(c, inplace)
    c = c.reshape(c.shape[0], -1)
    return divide(self_gram(c), c.shape[1])


def fused_pearson(x: torch.Tensor, moments=epilogue_cuda.row_moments,
                  halves=epilogue_cuda.standardize_split) -> torch.Tensor:
    """``pearson_graph`` of the ``[m, n]`` buffer ``x`` on the fused route: the
    rows' float64 moments over every column block, then ``split_gram`` with
    each block standardized and split by ``halves``.  ``moments`` and
    ``halves`` are the kernels' launchers, or their plain twins
    (``epilogue_cuda.row_moments_plain``, ``standardize_split_plain``) on any
    device."""
    blocks = blocks_of(x.shape[1])
    column_blocks["standardize"] += len(blocks)
    standardize_routes["fused"] += 1
    gram_routes["split"] += 1
    halves = partial(halves, x, moments(x, blocks))
    return divide(split_gram(x, halves), x.shape[1])


def pearson_device(counts1, counts2, row_standardize: bool = True,
                   device=None) -> torch.Tensor:
    """[m1, n] x [m2, n] -> [m1, m2] Pearson r matrix (float32, on ``device``)."""
    dev = resolve_device(device)
    c1 = as_float32(counts1, dev)
    c2 = as_float32(counts2, dev)
    if row_standardize:
        c1 = _row_standardize(c1)
        c2 = _row_standardize(c2)
    return matmul_nt(c1, c2)


def standardize_rows(counts, device=None) -> torch.Tensor:
    """Row-standardized copy on ``device`` (the Pearson operand form), for scoring
    many query batches against one fixed target matrix."""
    return _row_standardize(as_float32(counts, resolve_device(device)))


def pearson_against_standardized(counts1, targets_std, device=None) -> torch.Tensor:
    """[q, n] raw x [t, n] PRE-standardized -> [q, t] Pearson r matrix.

    Bitwise equal to ``pearson_device(counts1, targets)`` when
    ``targets_std = standardize_rows(targets)``.
    """
    dev = resolve_device(device)
    c1 = _row_standardize(as_float32(counts1, dev))
    return matmul_nt(c1, as_float32(targets_std, dev))


def pearson_pairs(counts, ii, jj, row_standardize: bool = True,
                  chunk: int = 65536, device=None) -> np.ndarray:
    """r-values of selected row pairs, without forming any r-matrix.

    ``out[t] = pearson(counts[ii[t]], counts[jj[t]])``: O(pairs * n) gather and
    multiply-sum on ``device`` instead of the O(m^2 n) GEMM -- the engine of the
    sampled find_dist, where only ``subset_size`` of the m(m-1)/2 pool is
    fitted (seekr/find_dist.py:166-171).  Rows are standardized once; pairs go
    in chunks of ``chunk``.  Indices are numpy-style (negative ones count from
    the end) and checked on the host first, so an out-of-range index raises
    ``IndexError`` as the reference's numpy indexing does.
    """
    dev = resolve_device(device)
    c = as_float32(counts, dev)
    if row_standardize:
        c = _row_standardize(c)
    ii = np.asarray(ii, dtype=np.int64).ravel()
    jj = np.asarray(jj, dtype=np.int64).ravel()
    m = int(c.shape[0])
    for name, arr in (("ii", ii), ("jj", jj)):
        if arr.size and (int(arr.min()) < -m or int(arr.max()) >= m):
            raise IndexError(
                f"{name} contains indices outside [-{m}, {m}) for a "
                f"{m}-row count matrix")
    ii = torch.as_tensor(np.where(ii < 0, ii + m, ii), device=dev)
    jj = torch.as_tensor(np.where(jj < 0, jj + m, jj), device=dev)
    out = torch.empty(ii.shape[0], dtype=torch.float32, device=dev)
    for start in range(0, ii.shape[0], chunk):
        a = c.index_select(0, ii[start:start + chunk])
        b = c.index_select(0, jj[start:start + chunk])
        out[start:start + chunk] = divide((a * b).sum(dim=1), c.shape[1])
    return out.cpu().numpy()


class _RowFiller:
    """Writer that fills a preallocated array with streamed row blocks."""

    def __init__(self, out: np.ndarray):
        self.out = out
        self.row = 0

    def append(self, block):
        block = np.asarray(block)
        self.out[self.row:self.row + block.shape[0]] = block
        self.row += block.shape[0]


def pearson_blocked(counts1, counts2, row_standardize: bool = True,
                    block_rows: int = 4096, device=None) -> np.ndarray:
    """Row-blocked Pearson into a host array, for outputs too large to hold on
    the device at once.  The blocked GEMM lives in ``io.stream.stream_pearson``.
    """
    from seekr_tpu_torch.io.stream import stream_pearson  # io.stream imports this module

    m1 = counts1.shape[0]
    m2 = counts2.shape[0]
    out = np.empty((m1, m2), dtype=np.float32)
    stream_pearson(counts1, counts2, _RowFiller(out), block_rows=block_rows,
                   row_standardize=row_standardize, device=device)
    return out
