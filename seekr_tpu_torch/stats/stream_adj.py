"""Bounded-memory multiple-comparison correction of a disk-resident matrix.

Port of ``seekr_tpu/stats/stream_adj.py`` (host code: numpy memmaps and
scratch files; the writers are the port's ``io.stream``).  The in-memory chain
(``stats.adj_pval`` -> ``stats.multitest``) holds the p-value matrix, its value
vector, the sort permutation and the corrected vector in RAM.
``adj_pval_stream`` corrects a matrix that stays on disk, with bounded host
memory and sequential disk traffic only:

  pass A    a chunked scan of the memmapped input: extract the upper-triangle
            (or all) values, and partition (value, original index) pairs into
            256 value-bucket files by sampled-quantile sort keys.
  sweep     the value buckets in sorted order (descending for the suffix-min
            methods, ascending for prefix-max): each bucket sorts in RAM, its
            global ranks come from the bucket counts' prefix sums, corrected
            values are computed with the arithmetic of ``stats.multitest``
            (same ops, same order, float64), and a monotone carry links the
            buckets, so the result is the one-shot accumulate's, bit for bit.
            A bucket above the in-RAM cap (a tie mass: empirical p-values take
            N+1 values, fitted ones saturate at 0.0/1.0) never loads whole: an
            all-equal bucket streams in append order, which is its stable
            sorted order, and a mixed one is byte-radix refined into bounded
            segments first (``_bucket_segments``).  Corrected values go to
            output row-group files; each value bucket is deleted once consumed.
  assembly  per row group: one [rows, m2] block, NaN outside the corrected
            cells (the symmetric fill), appended to the .npy / CSV writers.

Every method of ``stats.multitest`` but ``hommel`` (O(n^2) over the sorted
vector) is supported, and its output is the in-memory ``adj_pval``'s, bitwise,
NaN propagation and the symmetric NaN fill included.
"""

from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np

_SUFFIX_MIN = {"fdr_bh", "fdr_by", "simes-hochberg", "fdr_tsbh",
               "fdr_tsbky"}
_PREFIX_MAX = {"holm", "holm-sidak"}
_N_BUCKETS = 256


def _sortable_bits(vals: np.ndarray) -> np.ndarray:
    """Order-preserving unsigned-int transform of a float array.

    Standard total-order trick: flip all bits of negatives, set the sign
    bit of non-negatives.  Ascending unsigned order == ascending float
    order, with quiet NaNs (sign bit clear) above +inf — matching
    numpy's sort-NaNs-last convention that the in-memory path relies on.
    (A negative-signed NaN would sort first instead; p-values are
    computed as 1-cdf / ecdf and cannot produce one.)
    """
    if vals.dtype == np.float64:
        u = vals.view(np.uint64)
        sign = np.uint64(1) << np.uint64(63)
    else:
        u = np.ascontiguousarray(vals, np.float32).view(np.uint32)
        sign = np.uint32(1) << np.uint32(31)
    return np.where(u & sign, ~u, u | sign)


def _sample_boundaries(mm, symmetric: bool, n_rows_sample: int = 128,
                       per_row: int = 8192) -> np.ndarray:
    """255 bucket-boundary keys from sampled quantiles.

    Fixed byte-prefix buckets are catastrophically skewed for p-values:
    every float in [0.5, 1) shares one exponent byte, so half the data
    can land in a single bucket (an in-RAM sort of n/2 values — the
    exact blow-up bucketing exists to avoid).  Sampled quantiles bound
    every bucket at ~n/256 (+ sampling error), independent of the value
    distribution; exactness is unaffected — bucket ids only place a
    value's RANK RANGE, the in-bucket sort and histogram prefix sums
    stay exact.
    """
    m1, m2 = mm.shape
    rows = np.unique(np.linspace(0, m1 - 1,
                                 min(n_rows_sample, m1)).astype(np.int64))
    sample = []
    for i in rows:
        row = np.asarray(mm[int(i)])
        vals = row[int(i) + 1:] if symmetric else row
        if len(vals) > per_row:
            vals = vals[:: len(vals) // per_row][:per_row]
        if len(vals):
            sample.append(vals.copy())
    if not sample:
        return np.zeros(_N_BUCKETS - 1, np.uint64)
    keys = np.sort(_sortable_bits(np.concatenate(sample)))
    pick = np.linspace(0, len(keys) - 1, _N_BUCKETS + 1)[1:-1]
    return keys[pick.astype(np.int64)]


class _PairStore:
    """Append-only (values, int64 index) pair files, one per partition.

    At most ``_MAX_OPEN`` partitions keep file handles open (appends
    reopen transparently): the ROW-GROUP store has one partition per
    output block — ~1,900 files at the 180k extreme, past the common
    1024-fd default ulimit if every handle stayed open.

    ``track_keys=True`` additionally records the min/max sort key seen
    per partition (as uint64; float32 keys are zero-extended, order
    preserved).  min == max proves every value in the partition is
    bit-identical — the tie-mass detector the oversized-bucket path
    runs on.
    """

    _MAX_OPEN = 128

    def __init__(self, scratch: str, prefix: str, n_parts: int, dtype,
                 track_keys: bool = False):
        self.scratch = scratch
        self.prefix = prefix
        self.dtype = np.dtype(dtype)
        self.counts = np.zeros(n_parts, dtype=np.int64)
        self._vfh = {}
        self._ifh = {}
        if track_keys:
            self.minkey = np.full(n_parts, np.iinfo(np.uint64).max,
                                  dtype=np.uint64)
            self.maxkey = np.zeros(n_parts, dtype=np.uint64)
        else:
            self.minkey = self.maxkey = None

    def _path(self, kind: str, p: int) -> str:
        return os.path.join(self.scratch, f"{self.prefix}{kind}{p:05d}")

    def append(self, p: int, vals: np.ndarray, idx: np.ndarray) -> None:
        if p not in self._vfh:
            if len(self._vfh) >= self._MAX_OPEN:
                # evict the least-recently-appended partition (dicts
                # iterate in insertion order; re-inserting on every
                # append keeps that order = LRU)
                old = next(iter(self._vfh))
                self._vfh.pop(old).close()
                self._ifh.pop(old).close()
            self._vfh[p] = open(self._path("v", p), "ab")
            self._ifh[p] = open(self._path("i", p), "ab")
        else:
            # refresh LRU position
            self._vfh[p] = self._vfh.pop(p)
            self._ifh[p] = self._ifh.pop(p)
        self._vfh[p].write(np.ascontiguousarray(vals, self.dtype).tobytes())
        self._ifh[p].write(np.ascontiguousarray(idx, np.int64).tobytes())
        self.counts[p] += len(vals)

    def add_partitioned(self, part_ids: np.ndarray, vals: np.ndarray,
                        idx: np.ndarray, keys=None) -> None:
        """Partition one chunk by id (single stable counting sort)."""
        order = np.argsort(part_ids, kind="stable")
        vals, idx, part_ids = vals[order], idx[order], part_ids[order]
        if self.minkey is not None:
            keys = (np.asarray(keys, np.uint64)[order] if keys is not None
                    else _sortable_bits(vals).astype(np.uint64))
        present = np.unique(part_ids)
        bounds = np.searchsorted(part_ids, present)
        bounds = np.append(bounds, len(part_ids))
        for j, p in enumerate(present):
            lo, hi = bounds[j], bounds[j + 1]
            self.append(int(p), vals[lo:hi], idx[lo:hi])
            if self.minkey is not None:
                p = int(p)
                kseg = keys[lo:hi]
                self.minkey[p] = min(self.minkey[p], kseg.min())
                self.maxkey[p] = max(self.maxkey[p], kseg.max())

    def close_writes(self):
        for fh in list(self._vfh.values()) + list(self._ifh.values()):
            fh.close()
        self._vfh.clear()
        self._ifh.clear()

    def read(self, p: int):
        """(values, indices) of one partition, in append order."""
        vals = np.fromfile(self._path("v", p), dtype=self.dtype)
        idx = np.fromfile(self._path("i", p), dtype=np.int64)
        return vals, idx

    def drop(self, p: int) -> None:
        for kind in ("v", "i"):
            try:
                os.unlink(self._path(kind, p))
            except FileNotFoundError:
                pass


class _Seg:
    """One rank-contiguous slice of a value bucket's sorted order.

    ``equal=True`` means every value in the segment is bit-identical, so
    its file's APPEND order IS its stable sorted order — it can be
    consumed in bounded chunks (forward or backward) with no sort and no
    full read.  ``equal=False`` segments are small enough (<= the
    in-RAM cap) to load and stable-sort whole.
    """

    __slots__ = ("vpath", "ipath", "cnt", "equal")

    def __init__(self, vpath, ipath, cnt, equal):
        self.vpath, self.ipath = vpath, ipath
        self.cnt, self.equal = int(cnt), bool(equal)

    def drop(self):
        for path in (self.vpath, self.ipath):
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass


def _iter_pair_file_chunks(seg: _Seg, dtype, chunk_pairs: int,
                           reverse: bool):
    """Yield (vals, idx, offset) chunks of a pair file, <= chunk_pairs
    each, in forward or reverse FILE order (within a chunk the order is
    always file order — for an all-equal segment that is ascending
    stable rank order either way)."""
    dtype = np.dtype(dtype)
    starts = list(range(0, seg.cnt, chunk_pairs))
    if reverse:
        starts.reverse()
    for off in starts:
        cnt = min(chunk_pairs, seg.cnt - off)
        vals = np.fromfile(seg.vpath, dtype=dtype, count=cnt,
                           offset=off * dtype.itemsize)
        idx = np.fromfile(seg.ipath, dtype=np.int64, count=cnt,
                          offset=off * 8)
        yield vals, idx, off


def _refine_segments(vpath, ipath, cnt, dtype, lokey, hikey, cap,
                     scratch, chunk_pairs) -> list:
    """Decompose one oversized mixed-value bucket into ascending
    rank-contiguous segments, each all-equal or <= ``cap`` pairs.

    Byte-radix refinement at the FIRST DIFFERING BYTE of the bucket's
    min/max sort keys: one sequential partition pass into <= 256
    sub-buckets (stable — append order preserved within each).  Both
    the min- and max-key values are present in the data, and they land
    in different sub-buckets, so every level strictly splits; child
    min/max keys share the partition byte, so the differing-byte
    position strictly decreases — depth is bounded by the key width
    (8), and in practice tie-dominated buckets resolve immediately
    because an all-equal child is detected from its min == max metadata
    with no further pass.  The parent pair files are consumed (unlinked
    right after the partition pass) so scratch high-water stays ~1x."""
    shift = np.uint64(8 * ((int(lokey ^ hikey).bit_length() - 1) // 8))
    sub_scratch = tempfile.mkdtemp(prefix="refine_", dir=scratch)
    sub = _PairStore(sub_scratch, "q", 256, dtype, track_keys=True)
    src = _Seg(vpath, ipath, cnt, False)
    for vals, idx, _ in _iter_pair_file_chunks(src, dtype, chunk_pairs,
                                               reverse=False):
        keys = _sortable_bits(vals).astype(np.uint64)
        sub.add_partitioned(((keys >> shift) & np.uint64(0xFF)
                             ).astype(np.int64), vals, idx, keys)
    sub.close_writes()
    src.drop()
    segs = []
    for p in range(256):
        c = int(sub.counts[p])
        if c == 0:
            continue
        vp, ip = sub._path("v", p), sub._path("i", p)
        if sub.minkey[p] == sub.maxkey[p]:
            segs.append(_Seg(vp, ip, c, True))
        elif c <= cap:
            segs.append(_Seg(vp, ip, c, False))
        else:
            segs.extend(_refine_segments(vp, ip, c, dtype, sub.minkey[p],
                                         sub.maxkey[p], cap, scratch,
                                         chunk_pairs))
    return segs


def _bucket_segments(store: _PairStore, b: int, cap: int, scratch,
                     chunk_pairs: int) -> list:
    """Ascending segment decomposition of value bucket ``b`` (memoize —
    the two-stage reject count and the correction sweep share it)."""
    cnt = int(store.counts[b])
    if cnt == 0:
        return []
    vp, ip = store._path("v", b), store._path("i", b)
    if store.minkey[b] == store.maxkey[b]:
        return [_Seg(vp, ip, cnt, True)]
    if cnt <= cap:
        return [_Seg(vp, ip, cnt, False)]
    return _refine_segments(vp, ip, cnt, store.dtype, store.minkey[b],
                            store.maxkey[b], cap, scratch, chunk_pairs)


def _evict(arr) -> None:
    """Flush + MADV_DONTNEED a memmapped array so its resident pages do
    not accumulate in the process RSS across a multi-GB streaming pass
    (clean pages drop immediately; dirty ones after the flush)."""
    import mmap as _mmap

    base = arr
    while getattr(base, "base", None) is not None and not isinstance(
            base, np.memmap):
        base = base.base
    mm = getattr(base, "_mmap", None)
    if mm is None:
        return
    try:
        if isinstance(base, np.memmap) and base.mode != "r":
            base.flush()
        mm.madvise(_mmap.MADV_DONTNEED)
    except (AttributeError, OSError, ValueError):
        pass  # eviction is best-effort (platform-dependent)


def _tiled_symmetric_mm(mm, tile: int = 4096) -> bool:
    """adj_pval's 5-decimal transpose test over a memmapped matrix —
    mirror tiles only, early exit, never a full-matrix copy."""
    m = mm.shape[0]
    for i0 in range(0, m, tile):
        i1 = min(i0 + tile, m)
        for j0 in range(i0, m, tile):
            j1 = min(j0 + tile, m)
            a = np.round(np.asarray(mm[i0:i1, j0:j1]), 5)
            bt = np.round(np.asarray(mm[j0:j1, i0:i1]), 5).T
            eq = a == bt
            if not eq.all():
                if not (eq | (np.isnan(a) & np.isnan(bt))).all():
                    return False
    return True


def _iter_value_chunks(mm, symmetric: bool, chunk_rows: int):
    """Yield (values, flat output indices int64) per row chunk.

    Symmetric mode yields only the strict upper triangle (matching
    utils.adj.triu_values row-major order per chunk); indices address
    the [m1, m2] output matrix row-major.
    """
    m1, m2 = mm.shape
    for i0 in range(0, m1, chunk_rows):
        i1 = min(i0 + chunk_rows, m1)
        block = np.asarray(mm[i0:i1])
        if not symmetric:
            idx = (np.arange(i0, i1, dtype=np.int64)[:, None] * m2
                   + np.arange(m2, dtype=np.int64)[None, :])
            yield block.reshape(-1), idx.reshape(-1)
            continue
        rows_i = np.arange(i0, i1, dtype=np.int64)
        cols = np.arange(m2, dtype=np.int64)
        mask = cols[None, :] > rows_i[:, None]
        idx = rows_i[:, None] * m2 + cols[None, :]
        yield block[mask], idx[mask]


def _ecdf_chunk(base: int, cnt: int, n: int, hsum: float) -> np.ndarray:
    """multitest._fdr_correct's ecdf buffer, restricted to global ranks
    [base, base+cnt) — same ops, same order, bitwise identical."""
    e = np.arange(base + 1.0, base + cnt + 1.0)
    e /= n
    if hsum:
        e /= hsum
    return e


def adj_pval_stream(pvals, method: str, alpha: float = 0.05,
                    outputname=None, out_npy=None, index=None,
                    columns=None, symmetric=None, scratch_dir=None,
                    chunk_cells: int = 32 << 20, out_dtype=np.float64,
                    unlink_input: bool = False, progress=None,
                    max_bucket_pairs=None):
    """Multiple-comparison correction of a disk-resident p-value matrix.

    ``pvals``: path to a .npy artifact (memmapped; float32 or float64)
    or an in-memory array.  ``outputname`` writes the labeled CSV the
    in-memory ``adj_pval`` would (labels default to pandas-style
    0..m-1); ``out_npy`` writes the corrected matrix as .npy.
    ``symmetric`` overrides the 5-decimal transpose detection (pass
    True/False when the caller already knows — the check itself is
    tiled and bounded, but reads the whole matrix once).  Returns None:
    results live on disk by design.

    Disk-constrained extremes: ``out_dtype=np.float32`` halves the .npy
    artifact (the correction math stays float64; only the stored
    artifact rounds — NOT bitwise vs the in-memory path), and
    ``unlink_input=True`` deletes the input .npy right after the
    extraction pass.  Scratch pair files are dropped as each stage
    consumes them.  ``progress`` (callable, gets stage strings) hooks
    long-run observability.

    ``max_bucket_pairs`` caps the in-RAM sort (default: max(chunk_cells,
    2x the balanced bucket size n/256)).  Buckets above the cap — the
    TIE-MASS case: empirical p-values are grid-quantized to N+1 distinct
    values and fitted ones saturate at exactly 0.0/1.0, and quantile
    boundaries cannot split equal keys — are decomposed into bounded
    segments: an all-equal bucket (detected from pass-A min/max key
    metadata, zero extra IO) streams in append order with NO sort at
    all, and a mixed oversized bucket is byte-radix refined
    (_refine_segments).  RSS stays bounded for ANY value distribution,
    and the output is still bitwise identical to the in-memory path.
    """
    from seekr_tpu_torch.stats.multitest import _METHOD_ALIASES, _harmonic_sum

    method = _METHOD_ALIASES.get(str(method).lower())
    if method is None:
        raise ValueError("method not recognized")
    if method == "hommel":
        raise ValueError(
            "hommel's adjustment is O(n^2) over the sorted vector and "
            "cannot stream; use stats.adj_pval (in-memory) for it")
    if not outputname and not out_npy:
        raise ValueError("adj_pval_stream writes artifacts only: pass "
                         "outputname= (csv) and/or out_npy= (.npy)")
    note = progress or (lambda msg: None)

    own_mm = isinstance(pvals, str)
    mm = np.load(pvals, mmap_mode="r") if own_mm else np.asarray(pvals)
    if mm.ndim != 2:
        raise ValueError(f"p-value matrix must be 2-D, got {mm.shape}")
    m1, m2 = (int(d) for d in mm.shape)
    if symmetric is None:
        note("symmetry check")
        symmetric = m1 == m2 and _tiled_symmetric_mm(mm)
    elif symmetric and m1 != m2:
        raise ValueError("symmetric=True needs a square matrix")
    # the in-memory path's user-facing mode messages (adj_pval.py parity)
    if symmetric:
        print("The input pvals is a symmetric matrix. Only the upper "
              "triangle of the matrix (excluding diagonal) is used for "
              "multiple comparison correction.")
    else:
        print("The input pvals is not a symmetric matrix. The total matrix "
              "is used for multiple comparison correction.")

    n = m1 * (m1 - 1) // 2 if symmetric else m1 * m2
    chunk_rows = max(1, int(chunk_cells) // max(1, m2))
    group_cells = chunk_rows * m2  # one output row-group per assembly block
    n_groups = -(-m1 * m2 // group_cells)

    scratch = tempfile.mkdtemp(prefix="seekr_adj_",
                               dir=scratch_dir
                               or os.environ.get("SEEKR_TPU_SCRATCH"))
    try:
        note("pass A: value partition")
        boundaries = _sample_boundaries(mm, symmetric)
        store = _PairStore(scratch, "b", _N_BUCKETS, mm.dtype,
                           track_keys=True)
        for vals, idx in _iter_value_chunks(mm, symmetric, chunk_rows):
            keys = _sortable_bits(vals)
            store.add_partitioned(
                np.searchsorted(boundaries, keys, side="right"), vals, idx,
                keys)
            _evict(mm)  # keep the input's page-cache residency bounded
        store.close_writes()
        assert int(store.counts.sum()) == n
        if unlink_input and own_mm:
            del mm  # release the mapping before unlinking
            os.unlink(pvals)

        note("correction sweep")
        cap = (int(max_bucket_pairs) if max_bucket_pairs
               else max(int(chunk_cells), 2 * (n // _N_BUCKETS)))
        chunk_pairs = max(1, min(int(chunk_cells), cap))
        seg_cache = {}

        def segments(b):
            if b not in seg_cache:
                seg_cache[b] = _bucket_segments(store, b, cap, scratch,
                                                chunk_pairs)
            return seg_cache[b]

        groups = _PairStore(scratch, "g", n_groups, np.float64)
        if n:
            _correct_sweep(store, groups, group_cells, n, method,
                           float(alpha),
                           _harmonic_sum(n) if method == "fdr_by" else 0.0,
                           note, segments, chunk_pairs)
        groups.close_writes()

        note("assembly")
        _assemble(groups, m1, m2, chunk_rows, symmetric, outputname,
                  out_npy, out_dtype, index, columns)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    return None


def _bucket_order(method: str):
    if method in _SUFFIX_MIN:
        return range(_N_BUCKETS - 1, -1, -1)
    return range(_N_BUCKETS)


def _correct_chunk(method_core: str, p64: np.ndarray, base: int, n: int,
                   hsum: float, carry):
    """Correct one rank-contiguous chunk of the globally sorted vector
    (``p64`` float64, ascending stable order, global ranks
    [base, base+len)).  Chunks must be visited in ``_bucket_order``
    direction with ``carry`` (the running unclipped min/max) threaded
    through; min/max are exact, so chunked accumulation is bitwise
    identical to one accumulate over the whole vector — the same ops in
    the same order as ``stats.multitest``.  Returns (corrected, carry).
    """
    cnt = len(p64)
    if method_core == "bonferroni":
        return np.clip(p64 * n, 0, 1), carry
    if method_core == "sidak":
        return np.clip(-np.expm1(n * np.log1p(-p64)), 0, 1), carry
    if method_core in ("holm", "holm-sidak"):
        factors = np.arange(n - base, n - base - cnt, -1,
                            dtype=np.float64)
        pre = (p64 * factors if method_core == "holm"
               else -np.expm1(factors * np.log1p(-p64)))
        np.maximum.accumulate(pre, out=pre)
        if carry is not None:
            np.maximum(pre, carry, out=pre)
        return np.clip(pre, 0, 1), pre[-1]
    if method_core == "simes-hochberg":
        factors = np.arange(n - base, n - base - cnt, -1,
                            dtype=np.float64)
        pre = p64 * factors
    else:  # fdr_bh / fdr_by core
        pre = p64 / _ecdf_chunk(base, cnt, n, hsum)
    np.minimum.accumulate(pre[::-1], out=pre[::-1])
    if carry is not None:
        np.minimum(pre, carry, out=pre)
    return np.clip(pre, 0, 1), pre[0]


def _correct_sweep(store: _PairStore, groups: _PairStore, group_cells: int,
                   n: int, method: str, alpha: float, hsum: float,
                   note, segments, chunk_pairs: int) -> None:
    bases = np.concatenate([[0], np.cumsum(store.counts)])[:-1]

    # two-stage FDR needs stage-1's reject count before any corrected
    # value can be scaled — one cheap extra sweep over the bucket values
    two_stage = method in ("fdr_tsbh", "fdr_tsbky")
    r1 = post = 0
    if two_stage:
        bky = method == "fdr_tsbky"
        alpha_prime = alpha / (1 + alpha) if bky else alpha
        post = (1 + alpha) if bky else 1.0
        r1 = _bh_reject_count(store, bases, n, alpha_prime, segments)
        method_core = "fdr_bh"
    else:
        method_core = method
    ascending = method_core not in _SUFFIX_MIN

    state = {"carry": None}  # running min (suffix) / max (prefix)

    def emit(vals, idx, cbase):
        corrected, state["carry"] = _correct_chunk(
            method_core, np.asarray(vals, np.float64), cbase, n, hsum,
            state["carry"])
        if two_stage:
            # multitest: np.clip(corr1 * post * ntests0 / n, 0, 1) with
            # ntests0 = n - r1 — reproduce the exact op order
            if r1 == 0 or r1 == n:
                corrected = np.clip(corrected * post, 0, 1)
            else:
                corrected = np.clip(corrected * post * (n - r1) / n, 0, 1)
        groups.add_partitioned(idx // group_cells, corrected, idx)

    for b in _bucket_order(method_core):
        if int(store.counts[b]) == 0:
            continue
        segs = segments(b)
        seg_bases = int(bases[b]) + np.concatenate(
            [[0], np.cumsum([s.cnt for s in segs], dtype=np.int64)])[:-1]
        walk = list(zip(segs, seg_bases))
        if not ascending:
            walk.reverse()
        for seg, sbase in walk:
            if seg.equal:
                # all-equal segment: append order IS stable rank order —
                # stream bounded chunks, no sort, never a full read
                for vals, idx, off in _iter_pair_file_chunks(
                        seg, store.dtype, chunk_pairs,
                        reverse=not ascending):
                    emit(vals, idx, int(sbase) + off)
            else:
                vals = np.fromfile(seg.vpath, dtype=store.dtype)
                idx = np.fromfile(seg.ipath, dtype=np.int64)
                order = np.argsort(_sortable_bits(vals), kind="stable")
                emit(vals[order], idx[order], int(sbase))
            seg.drop()
        store.drop(b)  # value-pair files shrink as group files grow


def _bh_reject_count(store: _PairStore, bases, n: int, alpha: float,
                     segments) -> int:
    """Stage-1 BH reject count: the last global rank r with
    p_sorted[r] <= ecdf[r] * alpha (multitest._fdr_correct's rule,
    same arithmetic), +1.  One ascending value-only sweep; an all-equal
    segment needs only its LAST rank's threshold (the threshold grows
    with rank while the value is constant, so the last rank decides),
    computed with the exact _ecdf_chunk arithmetic — never a full read.
    """
    last = -1
    for b in range(_N_BUCKETS):
        if int(store.counts[b]) == 0:
            continue
        sbase = int(bases[b])
        for seg in segments(b):
            if seg.equal:
                v = np.float64(np.fromfile(seg.vpath, dtype=store.dtype,
                                           count=1)[0])
                # arange's last element (base+cnt) is an exact integer
                # < 2^53; /= n then *= alpha elementwise == these ops
                e = np.float64(sbase + seg.cnt)
                e = e / n
                if v <= e * alpha:
                    last = sbase + seg.cnt - 1
            else:
                vals = np.fromfile(seg.vpath, dtype=store.dtype)
                vals = vals[np.argsort(_sortable_bits(vals),
                                       kind="stable")]
                thr = _ecdf_chunk(sbase, seg.cnt, n, 0.0)
                thr *= alpha
                below = np.asarray(vals, np.float64) <= thr
                nz = np.nonzero(below)[0]
                if nz.size:
                    last = sbase + int(nz.max())
            sbase += seg.cnt
    return last + 1


def _assemble(groups: _PairStore, m1: int, m2: int, chunk_rows: int,
              symmetric: bool, outputname, out_npy, out_dtype, index,
              columns) -> None:
    """Sequential output pass: one [rows, m2] block per row group,
    corrected values placed, NaN elsewhere (= the symmetric fill; a
    full-matrix correction writes every cell), appended to the
    writers."""
    from seekr_tpu_torch.io.stream import StreamingCsvWriter, StreamingNpyWriter

    sinks = []
    group_cells = chunk_rows * m2
    g = 0
    # sink construction, the assembly loop, AND the close loop share one
    # discard-on-error envelope (see find_pval._stream_pvals): no partial
    # artifact may publish and no .part may leak; discard() is a safe
    # no-op on sinks that already closed
    try:
        if out_npy:
            sinks.append(StreamingNpyWriter(out_npy, (m1, m2), out_dtype))
        if outputname:
            if columns is None:
                columns = [str(i) for i in range(m2)]
            if index is None:
                index = [str(i) for i in range(m1)]
            # the in-memory path (and the reference, adj_pval.py:90)
            # always append ".csv" — match it exactly so both paths name
            # artifacts identically for any outputname
            sinks.append(StreamingCsvWriter(
                f"{outputname}.csv",
                columns=columns, row_labels=index, fmt="%s"))
        for i0 in range(0, m1, chunk_rows):
            rows = min(chunk_rows, m1 - i0)
            block = np.full((rows, m2), np.nan, dtype=np.float64)
            if g < len(groups.counts) and groups.counts[g]:
                corrected, idx = groups.read(g)
                block.reshape(-1)[idx - g * group_cells] = corrected
                groups.drop(g)
            out_block = (block if np.dtype(out_dtype) == np.float64
                         else block.astype(out_dtype))
            for s in sinks:
                s.append(out_block if isinstance(s, StreamingNpyWriter)
                         else block)
            g += 1
        for s in sinks:
            s.close()
    except BaseException:
        for s in sinks:
            s.discard()
        raise
