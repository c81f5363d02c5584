"""Labeled and raw CSV for float matrices, without pandas.

Port of ``seekr_tpu/io/fast_csv.py``.  The writers produce the bytes that
seekr_tpu's pandas and native paths produce:

  * labeled (``write_labeled_csv``): ``pd.DataFrame(matrix, index,
    columns).to_csv(path)`` -- each float cell in its shortest repr (what
    ``'%s'`` of a numpy float32 or float64 gives), NaN as an empty cell, labels
    with csv-minimal quoting;
  * raw (``write_raw_csv``): ``np.savetxt(path, matrix, delimiter=',',
    fmt='%1.6f')``, which it calls.

A float32 or float64 matrix is written by the host C++ library's multithreaded
formatter (``native.write_csv_f32``/``f64``, mode 0 and ``'%1.6f'`` mode 1);
other inputs, and ``labeled_csv_bytes``, are formatted here a block at a time
with numpy, never with Python ``%`` per cell: a 13,000-column p-value matrix has
13 M cells.  Both give the same bytes.  Row labels are quoted here for both, so
an empty or NaN label is an empty cell as pandas writes it (seekr_tpu's native
writer quotes it).  ``read_labeled_csv`` reads the labeled form back into a
``LabeledMatrix``, the port's stand-in for the DataFrame of
``pd.read_csv(path, index_col=0)``; float32 values of a regular file come from
the C++ parser.
"""

from __future__ import annotations

import csv
import io
import os
import stat

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


def labeled_csv_bytes(matrix, index, columns) -> bytes:
    """The bytes of ``pd.DataFrame(matrix, index, columns).to_csv()``."""
    matrix = np.asarray(matrix)
    index, columns = list(index), list(columns)
    if matrix.shape != (len(index), len(columns)):
        # the failure the pandas path raises: never a structurally corrupt CSV
        raise ValueError(
            f"Shape of passed values is {matrix.shape}, indices imply "
            f"({len(index)}, {len(columns)})")
    return header_line(columns).encode() + format_rows(matrix, "%s",
                                                       [_quote(i) for i in index])


def native_writes(matrix, labels=None) -> bool:
    """Whether the C++ formatter writes ``matrix``: a non-empty 2-D float32 or
    float64 matrix whose (already quoted) labels hold no NUL byte, which a C
    string cannot carry."""
    return (matrix.ndim == 2 and matrix.dtype in (np.float32, np.float64)
            and matrix.size > 0
            and (labels is None or not any("\0" in label for label in labels)))


def write_native_rows(path, matrix, labels=None, header=None, fmt: str = "%s",
                      append: bool = False) -> None:
    """Rows of ``matrix`` through the C++ formatter: ``'%s'`` is the shortest
    repr (mode 0), ``'%1.6f'`` float32's ``np.savetxt`` cells (mode 1)."""
    from seekr_tpu_torch import native

    if matrix.dtype == np.float64 and fmt == "%s":
        native.write_csv_f64(path, matrix, header_line=header, row_label_cells=labels,
                             append=append)
    else:
        native.write_csv_f32(path, matrix, header_line=header, row_label_cells=labels,
                             mode={"%s": 0, "%1.6f": 1}[fmt], append=append)


def write_labeled_csv(path, matrix, index, columns) -> None:
    """Byte-identical to ``pd.DataFrame(matrix, index, columns).to_csv``."""
    matrix, index, columns = np.asarray(matrix), list(index), list(columns)
    labels = [_quote(i) for i in index]
    if native_writes(matrix, labels) and matrix.shape == (len(labels), len(columns)):
        write_native_rows(path, matrix, labels, header_line(columns))
        return
    data = labeled_csv_bytes(matrix, index, columns)
    with open(path, "wb") as fh:
        fh.write(data)


def write_raw_csv(path, matrix) -> None:
    """``np.savetxt(path, matrix, delimiter=',', fmt='%1.6f')``: seekr_tpu's
    raw form, through the C++ formatter for float32 and numpy otherwise."""
    matrix = np.asarray(matrix)
    if matrix.dtype == np.float32 and native_writes(matrix):
        write_native_rows(path, matrix, fmt="%1.6f")
        return
    np.savetxt(path, matrix, delimiter=",", fmt="%1.6f")


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


def _unquote(cell: str) -> str:
    """One still-quoted CSV cell, unquoted."""
    row = next(iter(csv.reader([cell])), [])
    return row[0] if row else ""


def _read_native(path):
    """(float32 values, header cells, label cells) from the C++ parser, or None
    where it refuses the file (a row of the wrong width, a cell that is not a
    number, a header it splits otherwise: the Python reader decides those)."""
    from seekr_tpu_torch import native

    try:
        data, header, raw_labels = native.read_csv_f32(path)
    except OSError:
        return None
    head_cells = next(csv.reader([header.rstrip("\r")]), [""])
    if len(head_cells) - 1 != data.shape[1]:
        return None
    return data, head_cells[1:], [_unquote(label) for label in raw_labels]


def read_labeled_csv(path, dtype=np.float64) -> LabeledMatrix:
    """``pd.read_csv(path, index_col=0)`` for the labeled float matrices this
    package writes: ``dtype`` values (empty cells are NaN), row labels typed as
    pandas types them (``_infer_index``), column labels kept as strings.

    float32 values of a regular file are parsed by the C++ reader, each cell
    correctly rounded to float32 as seekr_tpu's native reader does; anything
    else (float64, a pipe, a file the C++ reader refuses) is parsed here in
    float64.  The C++ reader is never given a FIFO: it would open it, find no
    size and close it, and the writer's data would be lost.
    """
    if np.dtype(dtype) == np.float32 and stat.S_ISREG(os.stat(path).st_mode):
        parsed = _read_native(path)
        if parsed is not None:
            data, columns, labels = parsed
            return LabeledMatrix(data, _infer_index(labels), columns)
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
    return LabeledMatrix(np.concatenate(blocks).astype(dtype, copy=False),
                         _infer_index(labels), columns)
