"""Blocked Pearson, streamed to a host writer.

Port of the GEMM half of ``seekr_tpu/io/stream.py`` (``:25``, ``:298-351``): m up
to ~180k rows makes the all-pairs r-matrix up to 10^10 cells, so it is emitted as
[block, m2] row blocks.  The CSV and NPY writers wait for the port's CLI.
"""

from __future__ import annotations

from seekr_tpu_torch.ops.pearson import _row_standardize, as_float32, matmul_nt
from seekr_tpu_torch.utils.device import resolve_device

# Above this many output cells, row blocks are streamed instead of computing
# the full matrix in one GEMM (seekr_tpu/io/stream.py:25).
STREAM_CELL_THRESHOLD = 64_000_000


def stream_pearson(counts1, counts2, writer, block_rows: int = 4096,
                   row_standardize: bool = True, device=None):
    """Blocked Pearson on ``device``, each [block, m2] tile handed to
    ``writer.append`` as a host numpy array.

    Both operands are standardized once; a self-comparison (``counts2 is
    counts1``) standardizes and holds one device copy.
    """
    dev = resolve_device(device)
    same = counts2 is counts1
    c1 = as_float32(counts1, dev)
    c2 = c1 if same else as_float32(counts2, dev)
    if row_standardize:
        c1 = _row_standardize(c1)
        c2 = c1 if same else _row_standardize(c2)
    for start in range(0, c1.shape[0], block_rows):
        writer.append(matmul_nt(c1[start:start + block_rows], c2).cpu().numpy())
