"""Launcher of the forward's symmetric split-TF32 GEMM (``csrc/sym_gemm.cu``).

No TPU kernel is replaced: seekr_tpu's Pearson Gram is plain XLA.  On the H100 the
split self Gram (``ops.pearson.split_gram``) ran as cuBLAS products that computed
both triangles of the symmetric r and passed it through HBM about 22 times a
forward (``X = hi lo^T``, ``X + X^T``, eight 512-column ``addmm_`` and a divide).
``sym_split_gemm_kernel`` computes each 128 x 128 tile on and above the diagonal
once from the TF32 halves of one column block, and writes r once a block: added
to the earlier blocks' sum, and on the last block divided by ``n`` and mirrored.

``tile_plan`` is the kernel's order of the tiles: bands of ``GROUP`` tile rows,
each band column by column, so that the ~132 tiles in flight share few operand
rows in the L2 cache.  The plain twin ``sym_split_gemm_plain`` computes the
whole square and mirrors its upper triangle.
``sym_split_gemm`` launches the kernel for CUDA tensors and runs the twin for CPU
tensors; ``counts`` adds one to ``launches`` and the plan's tiles to ``tiles`` for
each launch of the kernel, and nothing for the twin.
"""

from __future__ import annotations

import numpy as np
import torch

from seekr_tpu_torch.ops.precision import pearson_precision
from seekr_tpu_torch.utils.build import cuda_error_string, load_library

TILE = 128   # the kernel's output tile edge
GROUP = 8    # tile rows of one band of the plan

# Columns whose three TF32 products (``hi hi^T``, ``hi lo^T``, ``lo hi^T``) one
# tensor-core accumulator sums before it is added to the float32 total with a
# round-to-nearest add: the kernel's fold, ``kFoldColumns`` in csrc/sym_gemm.cu
# (a constant there; a fold sweep rebuilds the kernel).  The tensor cores'
# float32 sums are not rounded to nearest, and their error grows with the
# accumulator's magnitude and the number of wgmma steps added into it, so in
# proportion to the fold's columns times the products it sums.  On the H100,
# over the 13,000 x 4,096 operand of the k = 6 forward, r's largest error from
# float64 was 5.8e-6 at 512 columns, 3.0e-6 at 256, 1.5e-6 at 128 and 1.0e-6 at
# 64 (float32's SGEMM 4.0e-6; the 2.5e-5 check), with the kernel at 5.5 ms for
# each fold down to 128 and 9.0 ms at 64, where the folds' waits for the tensor
# cores show.
TF32_SUM_COLUMNS = 128

counts = {"launches": 0, "tiles": 0}

# (device, m) -> tile_plan(m) on that device
_plans: dict = {}


def tile_plan(m: int) -> np.ndarray:
    """``[tiles, 2]`` int32 (I, J) of every 128 x 128 tile of an ``[m, m]`` result
    with I <= J, in launch order."""
    t = max(-(-m // TILE), 0)
    bands = []
    for band in range(0, t, GROUP):
        rows = np.arange(band, min(band + GROUP, t))
        cols = np.arange(band, t)
        i, j = np.meshgrid(rows, cols)  # column by column
        keep = i <= j
        bands.append(np.stack([i[keep], j[keep]], axis=1))
    if not bands:
        return np.zeros((0, 2), dtype=np.int32)
    return np.concatenate(bands).astype(np.int32)


def _plan_on(m: int, device: torch.device) -> torch.Tensor:
    key = (device, m)
    if key not in _plans:
        _plans[key] = torch.as_tensor(tile_plan(m), device=device)
    return _plans[key]


def tiles_of(m: int) -> int:
    """Tiles of ``tile_plan(m)``: t (t + 1) / 2 of t tile rows."""
    t = max(-(-m // TILE), 0)
    return t * (t + 1) // 2


def _check(hi: torch.Tensor, lo: torch.Tensor, out: torch.Tensor) -> None:
    m, w = hi.shape if hi.dim() == 2 else (-1, -1)
    ok = (hi.dim() == 2 and lo.shape == hi.shape and m >= 1 and w >= 1
          and out.shape == (m, m) and out.is_contiguous())
    for t in (hi, lo, out):
        ok = ok and t.is_cuda and t.device == hi.device and t.dtype == torch.float32
    for t in (hi, lo):
        ok = ok and t.stride(1) == 1 and t.stride(0) % 4 == 0 and t.data_ptr() % 16 == 0
    if not ok or lo.stride(0) != hi.stride(0):
        raise ValueError(
            f"the symmetric GEMM takes float32 halves [m, w] (m, w >= 1) on one card, unit "
            f"column stride, one row stride that is a multiple of 4, 16-byte aligned, and a "
            f"contiguous float32 [m, m] out; got {tuple(hi.shape)} {hi.dtype} on "
            f"{hi.device} (strides {hi.stride()}, {lo.stride()}), out {tuple(out.shape)} "
            f"{out.dtype} on {out.device}")


def sym_split_gemm(hi: torch.Tensor, lo: torch.Tensor, out: torch.Tensor, first: bool,
                   last: bool, n: float) -> torch.Tensor:
    """One column block of the self Gram of ``a = hi + lo`` into ``out`` [m, m]:
    ``out = (out if not first) + hi hi^T + hi lo^T + lo hi^T``, each
    ``TF32_SUM_COLUMNS`` columns summed before a float32 add, and where ``last``
    divided by ``n`` with both triangles the upper one's values.  Only the upper
    triangle is meaningful before the last block.  CPU tensors take the plain twin."""
    if not hi.is_cuda:
        return sym_split_gemm_plain(hi, lo, out, first, last, n)
    _check(hi, lo, out)
    m, w = hi.shape
    plan = _plan_on(m, hi.device)
    stream = torch.cuda.current_stream(hi.device).cuda_stream
    err = load_library().seekr_sym_split_gemm(
        hi.data_ptr(), lo.data_ptr(), hi.stride(0), out.data_ptr(), m, w, plan.data_ptr(),
        len(plan), int(first), int(last), float(n), hi.device.index or 0, stream)
    if err:
        raise RuntimeError(f"sym_split_gemm failed to launch: CUDA error {err} "
                           f"({cuda_error_string(err)})")
    counts["launches"] += 1
    counts["tiles"] += len(plan)
    return out


def sym_split_gemm_plain(hi: torch.Tensor, lo: torch.Tensor, out: torch.Tensor, first: bool,
                         last: bool, n: float) -> torch.Tensor:
    """``sym_split_gemm``'s plain twin, on any device: the same folds in the same
    order, each ``hi hi^T + hi lo^T + lo hi^T`` of ``TF32_SUM_COLUMNS`` columns in
    float32, over the whole square, then the upper triangle mirrored.  It launches
    no kernel, so ``counts`` stays as it is."""
    m, w = hi.shape
    fold = TF32_SUM_COLUMNS
    total = None
    with pearson_precision(tf32=False):
        for c in range(0, w, fold):
            h, low = hi[:, c:c + fold], lo[:, c:c + fold]
            part = (h @ h.T).add_(h @ low.T).add_(low @ h.T)
            total = part if total is None else total.add_(part)
    if total is None:
        total = torch.zeros((m, m), dtype=out.dtype, device=out.device)
    if not first:
        total = out + total
    if last:
        total = total / torch.tensor(float(n), dtype=total.dtype, device=total.device)
        upper = torch.ones((m, m), dtype=torch.bool, device=out.device).triu_()
        total = torch.where(upper, total, total.T)
    out.copy_(total)
    return out
