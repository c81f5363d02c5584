"""Labeled and raw CSV for float matrices, without pandas.

Port of ``seekr_tpu/io/fast_csv.py``.  The writers produce the bytes that
seekr_tpu's pandas and native paths produce:

  * labeled (``write_labeled_csv``): ``pd.DataFrame(matrix, index,
    columns).to_csv(path)`` -- each float cell in its shortest repr (what
    ``'%s'`` of a numpy float32 or float64 gives), NaN as an empty cell, labels
    with csv-minimal quoting;
  * raw (``write_raw_csv``): ``np.savetxt(path, matrix, delimiter=',',
    fmt='%1.6f')``, which it calls.

Labeled cells are formatted a block at a time with numpy, never with Python
``%`` per cell: a 13,000-column p-value matrix has 13 M cells.  ``read_labeled_csv``
reads the labeled form back into a ``LabeledMatrix``, the port's stand-in for
the DataFrame of ``pd.read_csv(path, index_col=0)``.
"""

from __future__ import annotations

import csv
import io

import numpy as np

# cells formatted per block: bounds the [rows, cols, width] byte buffers
_BLOCK_CELLS = 1 << 21
_NEWLINE = ord("\n")


def _quote(cell) -> str:
    """csv-module minimal quoting of one cell of a row, as pandas emits it: an
    empty or NaN label is an empty cell (the csv module would quote a row's
    lone empty field)."""
    if str(cell) == "" or (isinstance(cell, float) and cell != cell):
        return ""
    buf = io.StringIO()
    csv.writer(buf, lineterminator="").writerow([str(cell)])
    return buf.getvalue()


class LabeledMatrix:
    """A float matrix with row labels (``index``) and column labels (``columns``):
    what a DataFrame holds where seekr_tpu returns one."""

    def __init__(self, values, index, columns):
        self.values = np.asarray(values)
        self.index = list(index)
        self.columns = list(columns)
        if self.values.shape != (len(self.index), len(self.columns)):
            raise ValueError(
                f"Shape of passed values is {self.values.shape}, indices imply "
                f"({len(self.index)}, {len(self.columns)})")

    @property
    def shape(self) -> tuple:
        return self.values.shape

    def to_csv(self, path) -> None:
        write_labeled_csv(path, self.values, self.index, self.columns)


# -- cell formatting ---------------------------------------------------------

def _shortest_cells(block: np.ndarray) -> np.ndarray:
    """Byte-string cells of ``block``: the shortest repr of each float (numpy's
    ``astype(str)``, which pandas' ``to_csv`` uses), NaN as an empty cell."""
    cells = block.astype(np.bytes_)
    if block.dtype.kind == "f":
        cells[np.isnan(block)] = b""
    return cells


def _csv_lines(cells: np.ndarray, labels=None) -> bytes:
    """[rows, cols] byte-string cells -> CSV lines: the cells of a row joined by
    commas, one line per row, led by ``labels[row]`` and a comma when labels are
    given (already quoted)."""
    rows, cols = cells.shape
    if rows == 0:
        return b""
    if cols == 0:
        return b"".join(label.encode() + b"\n" for label in labels) if labels \
            else b"\n" * rows
    width = cells.dtype.itemsize
    buf = np.zeros((rows, cols, width + 1), dtype=np.uint8)
    buf[:, :, :width] = cells.view(np.uint8).reshape(rows, cols, width)
    buf[:, :, width] = ord(",")
    buf[:, -1, width] = _NEWLINE
    keep = buf != 0
    body = buf[keep].tobytes()
    if labels is None:
        return body
    ends = np.cumsum(keep.reshape(rows, -1).sum(axis=1)).tolist()
    starts = [0] + ends[:-1]
    return b"".join(label.encode() + b"," + body[a:b]
                    for label, a, b in zip(labels, starts, ends))


def format_rows(block, fmt: str = "%s", labels=None) -> bytes:
    """CSV lines of a 2-D ``block``, each cell as ``fmt`` gives it, each line led
    by its already-quoted label when ``labels`` are given.  ``'%s'`` is numpy's
    shortest repr a block at a time; any other ``fmt`` is applied to each row's
    tuple with one Python ``%``, as ``np.savetxt`` does."""
    block = np.asarray(block)
    if fmt != "%s":
        row_fmt = ",".join([fmt] * block.shape[1]) + "\n"
        lines = [row_fmt % tuple(row) for row in block]
        if labels is not None:
            lines = [f"{label},{line}" for label, line in zip(labels, lines)]
        return "".join(lines).encode()
    rows = max(1, _BLOCK_CELLS // max(1, block.shape[1]))
    parts = []
    for start in range(0, block.shape[0], rows):
        part = block[start:start + rows]
        parts.append(_csv_lines(_shortest_cells(part),
                                None if labels is None else labels[start:start + rows]))
    return b"".join(parts)


# -- writers -----------------------------------------------------------------

def header_line(columns) -> str:
    return "," + ",".join(_quote(c) for c in columns) + "\n"


def write_labeled_csv(path, matrix, index, columns) -> None:
    """Byte-identical to ``pd.DataFrame(matrix, index, columns).to_csv``."""
    matrix = np.asarray(matrix)
    index, columns = list(index), list(columns)
    if matrix.shape != (len(index), len(columns)):
        # the failure the pandas path raises: never a structurally corrupt CSV
        raise ValueError(
            f"Shape of passed values is {matrix.shape}, indices imply "
            f"({len(index)}, {len(columns)})")
    with open(path, "wb") as fh:
        fh.write(header_line(columns).encode())
        fh.write(format_rows(matrix, "%s", [_quote(i) for i in index]))


def write_raw_csv(path, matrix) -> None:
    """``np.savetxt(path, matrix, delimiter=',', fmt='%1.6f')``: seekr_tpu's
    raw form, written by numpy itself."""
    np.savetxt(path, np.asarray(matrix), delimiter=",", fmt="%1.6f")


# -- reader ------------------------------------------------------------------

def _is_int(v: str) -> bool:
    # ASCII digits only: str.isdigit() accepts superscripts etc., which
    # int() then rejects with a ValueError pandas never raises
    body = v[1:] if v[:1] in "+-" else v
    return bool(body) and body.isascii() and body.isdigit()


def _is_float(v: str) -> bool:
    # Python float() accepts underscore-grouped literals ('1_000');
    # pandas' C parser does not -- reject them so the inferred dtype
    # matches pd.read_csv(index_col=0)
    if not v or "_" in v:
        return False
    try:
        float(v)
        return True
    except ValueError:
        return False


def _infer_index(labels):
    """Per-COLUMN dtype inference, matching pd.read_csv(index_col=0):
    all-int -> ints, all-float-like (empty cells = NaN, like pandas'
    missing-value handling) -> floats, else strings with empty cells as
    NaN."""
    if labels and all(_is_int(v) for v in labels):
        return [int(v) for v in labels]
    if labels and any(v != "" for v in labels) \
            and all(v == "" or _is_float(v) for v in labels):
        return [np.nan if v == "" else float(v) for v in labels]
    return [np.nan if v == "" else v for v in labels]


def _split_label(line: str) -> tuple[str, str]:
    """One data line -> (label cell, unquoted; the value cells as text)."""
    if line.startswith('"'):
        cells = next(csv.reader([line]))
        return cells[0], ",".join(cells[1:])
    label, _, values = line.partition(",")
    return label, values


def _parse_values(texts: list, n_cols: int) -> np.ndarray:
    n = len(texts) * n_cols
    if not n:
        return np.empty((len(texts), n_cols), dtype=np.float64)
    text = ",".join(texts)
    if ",," not in text and not text.startswith(",") and not text.endswith(","):
        # no empty cell: numpy's C parser (correctly rounded, as float() is)
        values = np.fromstring(text, dtype=np.float64, sep=",")
        if values.size == n:
            return values.reshape(len(texts), n_cols)
    cells = np.array(text.split(","))
    if cells.size != n:
        raise ValueError(f"expected {n_cols} values on each of {len(texts)} rows")
    cells = np.where(cells == "", "nan", cells)  # pandas reads an empty cell as NaN
    return cells.astype(np.float64).reshape(len(texts), n_cols)


def read_labeled_csv(path) -> LabeledMatrix:
    """``pd.read_csv(path, index_col=0)`` for the labeled float matrices this
    package writes: float64 values (empty cells are NaN), row labels typed as
    pandas types them (``_infer_index``), column labels kept as strings."""
    with open(path, newline="") as fh:
        header = fh.readline().rstrip("\r\n")
        columns = next(csv.reader([header]), [""])[1:]
        n_cols = len(columns)
        labels, blocks, texts = [], [], []
        per_block = max(1, _BLOCK_CELLS // max(1, n_cols))
        for line in fh:
            line = line.rstrip("\r\n")
            if not line:
                continue
            label, values = _split_label(line)
            labels.append(label)
            texts.append(values)
            if len(texts) == per_block:
                blocks.append(_parse_values(texts, n_cols))
                texts = []
        blocks.append(_parse_values(texts, n_cols))
    return LabeledMatrix(np.concatenate(blocks), _infer_index(labels), columns)
