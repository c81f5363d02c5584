"""ctypes bindings for the port's host C++ library.

Port of ``seekr_tpu/native/__init__.py``, over the port's own copy of the
sources (``native/src``), built by g++ at first use into
``seekr_tpu_torch/_build/`` (``native.build``):

  * ``leiden(...)`` -- Leiden community detection with the six quality
    functions the reference exposes through libleidenalg
    (seekr/kmer_leiden.py:115-122);
  * ``NativeFasta`` -- a single-pass FASTA parser and a multithreaded 2-bit
    batch encoder feeding the count kernels;
  * the CSV writers and reader (``write_csv_f32``/``f64``, ``read_csv_f32``);
  * the sorts and scans of the statistics chain (``argsort_f64``,
    ``scatter_by_order``, ``fdr_sorted``, ``fdr_adjust``, ``sym_round5``,
    ``triu_values_f64``, ``triu_fill_f64``).

One difference from seekr_tpu: the library is not optional.  A failed build
raises ``NativeBuildError`` from the first call that needs it, where seekr_tpu
warns and lets its callers fall back to Python.  Callers still choose the
Python path by their input gates (``io.encode._native_parse_is_safe``, the size
thresholds, ``SEEKR_TPU_HOST_SORT``); there the Python path is the semantics.
``native_available()`` and ``load_error()`` only report.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Sequence

import numpy as np

from seekr_tpu_torch.native.build import NativeBuildError, build_native_lib

_lib = None
_lib_path: Optional[str] = None
_load_error: Optional[str] = None
_load_lock = threading.Lock()

ALGORITHMS = (
    "ModularityVertexPartition",
    "RBConfigurationVertexPartition",
    "RBERVertexPartition",
    "CPMVertexPartition",
    "SurpriseVertexPartition",
    "SignificanceVertexPartition",
)


def _load():
    """The loaded library, built at first use; raises ``NativeBuildError``
    when it cannot be built or loaded (never an ``OSError``, which callers
    catch for an unreadable input file)."""
    global _lib, _lib_path, _load_error
    if _lib is not None:
        return _lib
    with _load_lock:
        if _lib is not None:
            return _lib
        try:
            path = build_native_lib()
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                raise NativeBuildError(f"cannot load {path}: {e}") from e
        except NativeBuildError as e:
            _load_error = str(e)
            raise
        _declare(lib)
        _lib, _lib_path, _load_error = lib, path, None
        return _lib


def library_path() -> str:
    """Path of the loaded library (built first if need be)."""
    _load()
    return _lib_path


def _declare(lib) -> None:
    """Argument and result types of every exported C function."""
    lib.seekr_leiden.restype = ctypes.c_int64
    lib.seekr_leiden.argtypes = [
        ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_char_p, ctypes.c_double, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.seekr_fasta_open.restype = ctypes.c_void_p
    lib.seekr_fasta_open.argtypes = [ctypes.c_char_p]
    lib.seekr_fasta_close.argtypes = [ctypes.c_void_p]
    lib.seekr_fasta_num_seqs.restype = ctypes.c_int64
    lib.seekr_fasta_num_seqs.argtypes = [ctypes.c_void_p]
    lib.seekr_fasta_seq_len.restype = ctypes.c_int64
    lib.seekr_fasta_seq_len.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.seekr_fasta_header_len.restype = ctypes.c_int64
    lib.seekr_fasta_header_len.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.seekr_fasta_header.restype = ctypes.c_int64
    lib.seekr_fasta_header.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                       ctypes.c_char_p, ctypes.c_int64]
    lib.seekr_fasta_seq.restype = ctypes.c_int64
    lib.seekr_fasta_seq.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                    ctypes.c_char_p, ctypes.c_int64]
    lib.seekr_fasta_encode_batch.restype = ctypes.c_int64
    lib.seekr_fasta_encode_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int8),
    ]
    lib.seekr_fasta_count_kmers.restype = ctypes.c_int64
    lib.seekr_fasta_count_kmers.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                            ctypes.POINTER(ctypes.c_float)]
    lib.seekr_write_csv_f32.restype = ctypes.c_int64
    lib.seekr_write_csv_f32.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_int64,
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32,
        ctypes.c_int32,
    ]
    lib.seekr_write_csv_f64.restype = ctypes.c_int64
    lib.seekr_write_csv_f64.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64, ctypes.c_int64,
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32,
    ]
    lib.seekr_csv_open.restype = ctypes.c_void_p
    lib.seekr_csv_open.argtypes = [ctypes.c_char_p]
    lib.seekr_csv_close.argtypes = [ctypes.c_void_p]
    for fn in ("seekr_csv_rows", "seekr_csv_cols", "seekr_csv_header_len"):
        getattr(lib, fn).restype = ctypes.c_int64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.seekr_csv_header.restype = ctypes.c_int64
    lib.seekr_csv_header.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_int64]
    lib.seekr_csv_label_len.restype = ctypes.c_int64
    lib.seekr_csv_label_len.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.seekr_csv_label.restype = ctypes.c_int64
    lib.seekr_csv_label.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                    ctypes.c_char_p, ctypes.c_int64]
    lib.seekr_csv_data.restype = ctypes.c_int64
    lib.seekr_csv_data.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_float)]
    lib.seekr_argsort_f64.restype = ctypes.c_int64
    lib.seekr_argsort_f64.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double),
    ]
    lib.seekr_scatter_f64_u8.restype = ctypes.c_int64
    lib.seekr_scatter_f64_u8.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.seekr_fdr_sorted_f64.restype = ctypes.c_int64
    lib.seekr_fdr_sorted_f64.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_double,
        ctypes.c_double, ctypes.POINTER(ctypes.c_double),
    ]
    lib.seekr_fdr_f64.restype = ctypes.c_int64
    lib.seekr_fdr_f64.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_double,
        ctypes.c_double, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.seekr_sym_round5_f64.restype = ctypes.c_int64
    lib.seekr_sym_round5_f64.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64]
    lib.seekr_triu_values_f64.restype = ctypes.c_int64
    lib.seekr_triu_values_f64.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double)]
    lib.seekr_triu_fill_f64.restype = ctypes.c_int64
    lib.seekr_triu_fill_f64.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_double,
        ctypes.POINTER(ctypes.c_double)]


def native_available() -> bool:
    """Whether the library builds and loads here (a report: callers of the
    bindings get the build's error instead)."""
    try:
        _load()
    except NativeBuildError:
        return False
    return True


def load_error() -> Optional[str]:
    """The build/load failure message, or None (diagnostics)."""
    return _load_error


def host_stats_native_ok(size: int, min_size: int) -> bool:
    """Single gate for every host-stats native kernel (sortops/statops).

    ``SEEKR_TPU_HOST_SORT=numpy`` disables them all (argsort, scatter,
    fused FDR, symmetric test, triu gather/fill) so a platform problem in
    the native engine has one kill switch and env-flip A/B parity tests
    cover every path; ``=native`` forces them regardless of ``size``.
    Otherwise the kernel runs natively when ``size >= min_size`` (callers
    pass their own threshold: element count for the sort paths, edge
    length for the matrix helpers).  It does not ask whether the library
    built: the kernel's call raises if it did not.
    """
    forced = os.environ.get("SEEKR_TPU_HOST_SORT", "").lower()
    if forced == "numpy":
        return False
    return forced == "native" or size >= min_size


def leiden(sources, targets, weights, n_nodes: int,
           algo: str = "RBERVertexPartition", resolution: float = 1.0,
           seed: Optional[int] = None) -> np.ndarray:
    """Community membership for an undirected weighted edge list.

    ``algo`` accepts the leidenalg class names used by the reference
    (seekr/kmer_leiden.py:115-122) or the short forms 'modularity',
    'rbconfig', 'rber', 'cpm', 'surprise', 'significance'.
    ``seed=None`` gives a nondeterministic run (reference setseed=False).
    Returns int32 [n_nodes] of 0-based community ids.
    """
    lib = _load()
    src = np.ascontiguousarray(sources, dtype=np.int64)
    dst = np.ascontiguousarray(targets, dtype=np.int64)
    if src.shape != dst.shape or src.ndim != 1:
        raise ValueError("sources/targets must be equal-length 1-D arrays")
    if seed is not None and int(seed) < 0:
        # -1 is the C ABI's "nondeterministic" sentinel; a user-supplied
        # negative seed must not silently mean that
        raise ValueError("seed must be None or a non-negative integer")
    n_edges = len(src)
    if weights is None:
        w_ptr = ctypes.POINTER(ctypes.c_double)()
    else:
        w = np.ascontiguousarray(weights, dtype=np.float64)
        if w.shape != src.shape:
            raise ValueError("weights must match the edge list length")
        w_ptr = w.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    membership = np.empty(n_nodes, dtype=np.int32)
    rc = lib.seekr_leiden(
        n_nodes, n_edges,
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        w_ptr,
        algo.encode(), float(resolution),
        -1 if seed is None else int(seed),
        membership.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc < 0:
        raise ValueError(f"seekr_leiden failed (algo={algo!r})")
    return membership


class NativeFasta:
    """Parsed FASTA file backed by the C++ reader."""

    def __init__(self, path: str):
        lib = _load()
        self._lib = lib
        self._h = lib.seekr_fasta_open(os.fspath(path).encode())
        if not self._h:
            raise IOError(f"could not open fasta: {path}")

    def _handle(self):
        """Guard against use-after-close: a null handle would segfault."""
        if not self._h:
            raise ValueError("NativeFasta is closed")
        return self._h

    def __len__(self) -> int:
        return int(self._lib.seekr_fasta_num_seqs(self._handle()))

    def header(self, i: int) -> str:
        n = self._lib.seekr_fasta_header_len(self._handle(), i)
        if n < 0:
            raise IndexError(i)
        buf = ctypes.create_string_buffer(n)
        self._lib.seekr_fasta_header(self._h, i, buf, n)
        return buf.raw.decode()

    def seq(self, i: int) -> str:
        n = self._lib.seekr_fasta_seq_len(self._handle(), i)
        if n < 0:
            raise IndexError(i)
        buf = ctypes.create_string_buffer(n)
        self._lib.seekr_fasta_seq(self._h, i, buf, n)
        return buf.raw.decode()

    def lengths(self) -> np.ndarray:
        m = len(self)
        return np.array([self._lib.seekr_fasta_seq_len(self._h, i)
                         for i in range(m)], dtype=np.int64)

    def _strings(self, length_of, copy_into):
        """Every record's string through one reused buffer: a fresh
        ``create_string_buffer`` per record, as ``header``/``seq`` take, made
        the native parse of a whole corpus slower than the Python reader."""
        h = self._handle()
        sizes = [length_of(h, i) for i in range(len(self))]
        buf = ctypes.create_string_buffer(max(sizes, default=0) or 1)
        out = []
        for i, n in enumerate(sizes):
            copy_into(h, i, buf, n)
            out.append(ctypes.string_at(buf, n).decode())
        return out

    def headers(self):
        return self._strings(self._lib.seekr_fasta_header_len, self._lib.seekr_fasta_header)

    def seqs(self):
        return self._strings(self._lib.seekr_fasta_seq_len, self._lib.seekr_fasta_seq)

    def count_kmers(self, k: int) -> np.ndarray:
        """[num_seqs, 4^k] float32 counts-per-kb, multithreaded on host.

        Same semantics as the device engine and the reference's
        ``occurrences`` loop; useful on accelerator-less hosts.
        """
        if not 1 <= int(k) <= 12:
            # validate BEFORE the (num_seqs, 4^k) allocation: k=16 would
            # attempt a multi-TB np.empty before C could return -1
            raise ValueError(f"count_kmers supports 1 <= k <= 12, got {k}")
        out = np.empty((len(self), 4 ** k), dtype=np.float32)
        rc = self._lib.seekr_fasta_count_kmers(
            self._handle(), int(k),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc != 0:
            raise ValueError(f"count_kmers failed (k={k})")
        return out

    def encode_batch(self, ids: Sequence[int], lpad: int) -> np.ndarray:
        """[len(ids), lpad] int8 digit matrix, padded with 4 (INVALID)."""
        ids_arr = np.ascontiguousarray(ids, dtype=np.int64)
        out = np.empty((len(ids_arr), lpad), dtype=np.int8)
        rc = self._lib.seekr_fasta_encode_batch(
            self._handle(),
            ids_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(ids_arr), lpad,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        )
        if rc != 0:
            raise ValueError("encode_batch failed (bad sequence index?)")
        return out

    def close(self):
        if self._h:
            self._lib.seekr_fasta_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def write_csv_f32(path: str, matrix: np.ndarray, header_line: str = None,
                  row_label_cells=None, mode: int = 0,
                  append: bool = False) -> None:
    """Write a float32 matrix as CSV via the multithreaded C++ formatter.

    ``header_line`` is written verbatim (include the trailing newline);
    ``row_label_cells`` are pre-quoted label strings prepended per row.
    mode 0 = pandas-float32-repr bytes, mode 1 = np.savetxt '%1.6f'.
    ``append`` opens the file in append mode (streamed row blocks).
    Callers are responsible for CSV-quoting labels (see io.fast_csv).
    """
    _write_csv_native(path, matrix, np.float32, header_line,
                      row_label_cells, mode, append)


def write_csv_f64(path: str, matrix: np.ndarray, header_line: str = None,
                  row_label_cells=None, append: bool = False) -> None:
    """float64 flavor of :func:`write_csv_f32` — pandas/Python repr
    bytes (``DataFrame(float64).to_csv``), NaN as empty cells; the
    streamed adj_pval CSV emitter's fast path."""
    _write_csv_native(path, matrix, np.float64, header_line,
                      row_label_cells, None, append)


def _write_csv_native(path, matrix, dtype, header_line, row_label_cells,
                      mode, append):
    """Shared body of the two CSV writers (they differ only in dtype,
    the ctypes entry, and f32's mode argument)."""
    lib = _load()
    m = np.ascontiguousarray(matrix, dtype=dtype)
    if m.ndim != 2:
        raise ValueError("matrix must be 2-D")
    rows, cols = m.shape
    labels_arr = None
    if row_label_cells is not None:
        if len(row_label_cells) != rows:
            raise ValueError("row_label_cells length must equal row count")
        labels_arr = (ctypes.c_char_p * rows)(
            *[str(s).encode("utf-8") for s in row_label_cells])
    header = header_line.encode("utf-8") if header_line else None
    if dtype is np.float32:
        name = "seekr_write_csv_f32"
        rc = lib.seekr_write_csv_f32(
            str(path).encode(),
            m.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), rows, cols,
            header, labels_arr, int(mode), int(bool(append)))
    else:
        name = "seekr_write_csv_f64"
        rc = lib.seekr_write_csv_f64(
            str(path).encode(),
            m.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), rows, cols,
            header, labels_arr, int(bool(append)))
    if rc != 0:
        raise IOError(f"{name} failed for {path!r}")


def argsort_f64(keys: np.ndarray):
    """Stable ascending argsort of a float64 vector, multithreaded.

    Returns ``(order int64[n], sorted_values float64[n])`` — the native
    LSD radix sort carries the values through, so the usual
    ``keys[order]`` random gather is free.  Matches
    ``np.argsort(keys, kind="stable")`` except that -0.0 sorts strictly
    before +0.0 (numpy ties them); NaNs sort to the end in stable order
    but with canonicalised payloads in the values output, so callers that
    care take numpy's sort when NaNs are present.
    """
    lib = _load()
    k = np.ascontiguousarray(keys, dtype=np.float64)
    if k.ndim != 1:
        raise ValueError("keys must be 1-D")
    n = len(k)
    order = np.empty(n, dtype=np.int64)
    sorted_vals = np.empty(n, dtype=np.float64)
    rc = lib.seekr_argsort_f64(
        k.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n,
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        sorted_vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if rc != 0:
        raise ValueError(f"seekr_argsort_f64 failed (rc={rc})")
    return order, sorted_vals


def scatter_by_order(values: np.ndarray, order: np.ndarray,
                     flags: Optional[np.ndarray] = None):
    """Inverse-permutation scatter ``out[order] = values``, multithreaded.

    ``order`` MUST be a permutation of 0..n-1 (like an argsort result):
    out-of-range indices raise, but duplicate indices are NOT detected
    by default — two threads would race the same output slot, unlike
    numpy's deterministic last-write-wins fancy indexing.  All in-tree
    call sites pass argsort-derived permutations; set
    ``SEEKR_TPU_CHECK_SCATTER=1`` to add an O(n) permutation check
    (debug aid for new callers).  ``flags`` (bool/uint8), when given, is
    scattered through the same permutation in the same pass; returns
    ``(out_values, out_flags)`` with ``out_flags`` None when ``flags``
    is None.
    """
    lib = _load()
    v = np.ascontiguousarray(values, dtype=np.float64)
    o = np.ascontiguousarray(order, dtype=np.int64)
    if v.ndim != 1 or o.shape != v.shape:
        raise ValueError("values/order must be equal-length 1-D arrays")
    if os.environ.get("SEEKR_TPU_CHECK_SCATTER") == "1" and len(o):
        # explicit range check first: numpy fancy assignment WRAPS
        # negative indices instead of raising, which would let a
        # non-permutation slip past the seen-mask test below
        if (o < 0).any() or (o >= len(o)).any():
            raise ValueError("order contains out-of-range indices")
        seen = np.zeros(len(o), dtype=bool)
        seen[o] = True
        if not seen.all():
            raise ValueError(
                "order is not a permutation (duplicate indices race "
                "across scatter threads)")
    n = len(v)
    out_vals = np.empty(n, dtype=np.float64)
    f_ptr = ctypes.POINTER(ctypes.c_uint8)()
    of_ptr = ctypes.POINTER(ctypes.c_uint8)()
    out_flags = None
    if flags is not None:
        f = np.ascontiguousarray(flags, dtype=np.uint8)
        if f.shape != v.shape:
            raise ValueError("flags must match the values length")
        out_flags = np.empty(n, dtype=np.uint8)
        f_ptr = f.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        of_ptr = out_flags.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    rc = lib.seekr_scatter_f64_u8(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), f_ptr,
        o.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n,
        out_vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), of_ptr)
    if rc != 0:
        raise ValueError(f"seekr_scatter_f64_u8 failed (rc={rc}; "
                         "out-of-range index?)")
    return out_vals, out_flags


def fdr_sorted(p_sorted: np.ndarray, alpha: float,
               harmonic_sum: float = 0.0):
    """BH/BY correction of an ascending-sorted p-value vector.

    Returns ``(corrected float64[n], n_reject int)`` — bitwise identical
    to multitest._fdr_correct's numpy math (``harmonic_sum`` selects BY;
    pass numpy's own pairwise ``sum(1/i)`` for bitwise parity there).
    """
    lib = _load()
    p = np.ascontiguousarray(p_sorted, dtype=np.float64)
    if p.ndim != 1:
        raise ValueError("p_sorted must be 1-D")
    corrected = np.empty(len(p), dtype=np.float64)
    rc = lib.seekr_fdr_sorted_f64(
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(p),
        float(alpha), float(harmonic_sum),
        corrected.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if rc < 0:
        raise ValueError(f"seekr_fdr_sorted_f64 failed (rc={rc})")
    return corrected, int(rc)


def fdr_adjust(pvals: np.ndarray, alpha: float, harmonic_sum: float = 0.0):
    """Fused BH/BY correction of an UNSORTED p-value vector.

    One native call runs the stable radix argsort, the suffix-min
    correction, and the unsort scatter with no Python temporaries.
    Returns ``(corrected float64[n], reject bool[n], n_reject int)`` in
    the ORIGINAL element order.  Raises ValueError with ``rc=-3`` text
    when NaNs are present — callers then take the numpy path, which
    propagates NaN exactly like statsmodels.
    """
    lib = _load()
    p = np.ascontiguousarray(pvals, dtype=np.float64)
    if p.ndim != 1:
        raise ValueError("pvals must be 1-D")
    corrected = np.empty(len(p), dtype=np.float64)
    reject = np.empty(len(p), dtype=np.uint8)
    rc = lib.seekr_fdr_f64(
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(p),
        float(alpha), float(harmonic_sum),
        corrected.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        reject.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc < 0:
        raise ValueError(f"seekr_fdr_f64 failed (rc={rc})")
    return corrected, reject.view(bool), int(rc)


def sym_round5(mat: np.ndarray) -> bool:
    """5-decimal-rounded transpose equality (NaN == NaN) of a square
    float64 matrix — adj_pval's symmetric-input test, tiled and
    multithreaded with early exit.  The input must already be contiguous
    float64 (callers check the dtype; converting here would change the
    rounding semantics the test is defined on)."""
    lib = _load()
    if (not isinstance(mat, np.ndarray) or mat.dtype != np.float64
            or mat.ndim != 2 or mat.shape[0] != mat.shape[1]
            or not mat.flags.c_contiguous):
        raise ValueError("sym_round5 needs a square C-contiguous float64 "
                         "matrix")
    rc = lib.seekr_sym_round5_f64(
        mat.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), mat.shape[0])
    if rc < 0:
        raise ValueError(f"seekr_sym_round5_f64 failed (rc={rc})")
    return bool(rc)


def triu_values_f64(mat: np.ndarray) -> np.ndarray:
    """Strict-upper-triangle values of a square C-contiguous float64
    matrix in row-major order, gathered in parallel."""
    lib = _load()
    if (not isinstance(mat, np.ndarray) or mat.dtype != np.float64
            or mat.ndim != 2 or mat.shape[0] != mat.shape[1]
            or not mat.flags.c_contiguous):
        raise ValueError("triu_values_f64 needs a square C-contiguous "
                         "float64 matrix")
    m = mat.shape[0]
    out = np.empty(m * (m - 1) // 2, dtype=np.float64)
    rc = lib.seekr_triu_values_f64(
        mat.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), m,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if rc != 0:
        raise ValueError(f"seekr_triu_values_f64 failed (rc={rc})")
    return out


def triu_fill_f64(m: int, flat: np.ndarray, fill: float = np.nan):
    """Scatter a row-major strict-upper-triangle vector back into an
    m x m float64 matrix (everything else = ``fill``), one parallel
    write pass over the output."""
    lib = _load()
    f = np.ascontiguousarray(flat, dtype=np.float64)
    if f.ndim != 1 or len(f) != m * (m - 1) // 2:
        raise ValueError("flat must be 1-D with m*(m-1)/2 entries")
    out = np.empty((m, m), dtype=np.float64)
    rc = lib.seekr_triu_fill_f64(
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), m, float(fill),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if rc != 0:
        raise ValueError(f"seekr_triu_fill_f64 failed (rc={rc})")
    return out


def read_csv_f32(path: str):
    """Parse a labeled float CSV via the multithreaded C++ reader.

    Returns (matrix float32 [rows, cols], header_line str, raw_label_cells
    list of still-CSV-quoted strings) or raises IOError on parse failure.
    Callers unquote labels/header with the csv module (io.fast_csv).
    """
    lib = _load()
    h = lib.seekr_csv_open(str(path).encode())
    if not h:
        raise IOError(f"seekr_csv_open failed for {path!r}")
    try:
        rows = lib.seekr_csv_rows(h)
        cols = lib.seekr_csv_cols(h)
        out = np.empty((rows, cols), dtype=np.float32)
        if lib.seekr_csv_data(
                h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))) != 0:
            raise IOError("seekr_csv_data failed")
        n = lib.seekr_csv_header_len(h)
        buf = ctypes.create_string_buffer(max(n, 1))
        lib.seekr_csv_header(h, buf, n)
        header = buf.raw[:n].decode("utf-8")
        labels = []
        for r in range(rows):
            ln = lib.seekr_csv_label_len(h, r)
            lbuf = ctypes.create_string_buffer(max(ln, 1))
            lib.seekr_csv_label(h, r, lbuf, ln)
            labels.append(lbuf.raw[:ln].decode("utf-8"))
        return out, header, labels
    finally:
        lib.seekr_csv_close(h)
