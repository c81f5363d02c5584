"""Streamed emission of huge matrices, and the blocked Pearson that feeds it.

Port of ``seekr_tpu/io/stream.py``: m up to ~180k rows makes the all-pairs
r-matrix up to 10^10 cells, so it never exists as one host array.  These writers
consume [block, m2] row blocks as they come off the device:

  * ``StreamingNpyWriter`` -- a standard .npy, its header written for the full
    shape first and row blocks appended (float32 C order);
  * ``StreamingCsvWriter`` -- labeled (pandas bytes) or raw (``'%1.6f'``) CSV
    row blocks, formatted with numpy (``io.fast_csv``);
  * ``ArrayCollector`` and ``TriuCollector`` -- the blocks gathered into one
    array, or only their strict upper triangle.

Both file writers are crash-consistent: every byte goes to ``<path>.part`` and
``close()`` publishes it with fsync + ``os.replace`` only after the full row
count arrived, so a failed run leaves the final path absent or complete.

``stream_pearson`` drives the blocked device GEMM through a writer.
"""

from __future__ import annotations

import os

import numpy as np

from seekr_tpu_torch.io.fast_csv import _quote, format_rows, header_line
from seekr_tpu_torch.ops.pearson import _row_standardize, as_float32, matmul_nt
from seekr_tpu_torch.utils.device import resolve_device

# Above this many output cells, row blocks are streamed instead of computing
# the full matrix in one GEMM (seekr_tpu/io/stream.py:25).
STREAM_CELL_THRESHOLD = 64_000_000


class StreamingNpyWriter:
    """Row-block appender producing a valid .npy for a known final shape."""

    def __init__(self, path: str, shape, dtype=np.float32):
        self.path = path if str(path).endswith(".npy") else f"{path}.npy"
        self.shape = tuple(int(s) for s in shape)
        self.dtype = np.dtype(dtype)
        self._tmp = self.path + ".part"
        self._fh = open(self._tmp, "wb")
        header = {"descr": self.dtype.str, "fortran_order": False,
                  "shape": self.shape}
        np.lib.format.write_array_header_2_0(self._fh, header)
        self._rows_written = 0
        self._done = False

    def append(self, block: np.ndarray):
        block = np.ascontiguousarray(block, dtype=self.dtype)
        if block.ndim != 2 or block.shape[1] != self.shape[1]:
            raise ValueError(f"block of shape {block.shape} for a {self.shape} array")
        if self._rows_written + block.shape[0] > self.shape[0]:
            raise ValueError("wrote too many rows")
        self._rows_written += block.shape[0]
        self._fh.write(block.tobytes())

    def close(self):
        if self._done:
            return  # idempotent: a second close must not touch anything
        if self._rows_written != self.shape[0]:
            msg = (f"expected {self.shape[0]} rows, "
                   f"wrote {self._rows_written}")
            self.discard()  # an incomplete artifact must never publish
            raise AssertionError(msg)
        self._fh.flush()
        os.fsync(self._fh.fileno())
        self._fh.close()
        os.replace(self._tmp, self.path)
        self._done = True

    def discard(self):
        """Drop any in-flight ``.part`` without touching the final path.

        Safe after close() (nothing in flight) and idempotent -- callers
        use it as the blanket cleanup in error paths.
        """
        if self._done:
            return
        self._fh.close()
        try:
            os.unlink(self._tmp)
        except FileNotFoundError:
            pass
        self._done = True

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.close()
        else:
            self.discard()


class ArrayCollector:
    """Writer that accumulates streamed row blocks into one host array."""

    def __init__(self):
        self.blocks = []

    def append(self, block):
        self.blocks.append(np.asarray(block))

    def result(self) -> np.ndarray:
        return np.vstack(self.blocks)


class TriuCollector:
    """Writer reducing streamed self-similarity blocks to the strict upper
    triangle on the fly.

    find_dist only consumes ``triu(sim, 1)`` of the background r-matrix, so
    each row's j > i tail is kept as the [block, m] blocks come off the device:
    peak host memory is the m(m-1)/2 triangle, preallocated, and the square
    never exists.  Bit-identical to ``utils.adj.triu_values`` of the collected
    matrix (row-major row tails).
    """

    def __init__(self, m: int, dtype=np.float32):
        self.m = int(m)
        self.dtype = np.dtype(dtype)
        self._row = 0
        self._out = np.empty(self.m * (self.m - 1) // 2, dtype=self.dtype)
        self._fill = 0

    def append(self, block):
        block = np.asarray(block)
        if block.ndim != 2 or block.shape[1] != self.m:
            raise ValueError(f"block of shape {block.shape} for {self.m} columns")
        for bi in range(block.shape[0]):
            i = self._row + bi
            tail = self.m - (i + 1)
            self._out[self._fill:self._fill + tail] = block[bi, i + 1:]
            self._fill += tail
        self._row += block.shape[0]

    def result(self) -> np.ndarray:
        if self._row != self.m:
            raise AssertionError(f"expected {self.m} rows, saw {self._row}")
        out = self._out
        self._out = np.empty(0, dtype=self.dtype)
        return out


class StreamingCsvWriter:
    """Row-block CSV appender: labeled like pandas (``fmt='%s'``), or raw.

    Labels take csv's minimal quoting, so names with commas (legal in FASTA
    headers) come out as pandas' ``to_csv`` writes them.  ``'%s'`` writes each
    float in its shortest repr and NaN as an empty cell, a block at a time with
    numpy; ``'%1.6f'`` and any other format are applied row by row as
    ``np.savetxt`` applies them (``io.fast_csv.format_rows``).

    Crash-consistent like StreamingNpyWriter: rows accumulate in
    ``<path>.part``; ``close()`` fsyncs and publishes with ``os.replace``.
    """

    def __init__(self, path: str, columns=None, row_labels=None,
                 fmt: str = "%1.6f"):
        self.path = path
        self._tmp = f"{path}.part"
        self.fmt = fmt
        self.row_labels = list(row_labels) if row_labels is not None else None
        self.labeled = columns is not None
        if self.labeled and self.row_labels is None:
            # fail before the header hits the disk: every labeled append
            # slices row_labels
            raise ValueError("StreamingCsvWriter: columns= requires "
                             "row_labels= (a labeled CSV has both)")
        with open(self._tmp, "w") as fh:
            if self.labeled:
                fh.write(header_line(columns))
        self._row = 0
        self._done = False

    def append(self, block: np.ndarray):
        block = np.asarray(block)
        labels = None
        if self.labeled:
            labels = [_quote(label) for label in
                      self.row_labels[self._row:self._row + block.shape[0]]]
        with open(self._tmp, "ab") as fh:
            fh.write(format_rows(block, self.fmt, labels))
        self._row += block.shape[0]

    def close(self):
        """Publish the accumulated rows atomically.

        A labeled writer knows its final row count (one label per row), so a
        shortfall discards instead of publishing a truncated artifact.
        Idempotent; a close after discard is a no-op, never a zero-byte
        publish over a valid file.
        """
        if self._done:
            return
        if self.labeled and self._row != len(self.row_labels):
            msg = (f"expected {len(self.row_labels)} rows, "
                   f"wrote {self._row}")
            self.discard()
            raise AssertionError(msg)
        if not os.path.exists(self._tmp):
            raise FileNotFoundError(
                f"{self._tmp} missing at close (discarded or externally "
                "removed); refusing to publish")
        with open(self._tmp, "a") as fh:
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(self._tmp, self.path)
        self._done = True

    def discard(self):
        """Drop any in-flight ``.part`` without touching the final path.

        Safe after close() and idempotent (blanket error-path cleanup).
        """
        if self._done:
            return
        try:
            os.unlink(self._tmp)
        except FileNotFoundError:
            pass
        self._done = True

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.close()
        else:
            self.discard()


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
