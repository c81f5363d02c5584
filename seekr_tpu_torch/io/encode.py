"""Tokenize nucleotide strings into dense device-ready arrays.

Port of ``seekr_tpu/io/encode.py``.  Each base is encoded to a 2-bit digit once on
the host and padded ``[rows, L]`` int8 arrays go to the device, where k-mer window
codes are formed and histogrammed (seekr_tpu_torch.ops.count).  ``encode_fasta``
parses and encodes a FASTA file with the host C++ library (``native``) when the
file's bytes cannot make it differ from the Python reader, and with the Python
path otherwise.

Column-order contract: the reference enumerates k-mers as
``itertools.product("AGTC", repeat=k)`` (seekr/kmer_counts.py:100,121-122), i.e.
base-4 digits with A=0, G=1, T=2, C=3 and the FIRST character most significant.
The encoder uses exactly that digit assignment, so histogram bins line up with
reference CSV columns with no permutation.

Bases outside the alphabet (N, IUPAC codes, ...) get the sentinel INVALID; any
window containing one is skipped while the per-kb denominator still uses the full
``len(seq) - k + 1`` window count (reference kmer_counts.py:144-150).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from seekr_tpu_torch.utils.profiler import span

ALPHABET_AGTC = "AGTC"
INVALID = 4  # any value >= 4 marks a non-alphabet base; also used for padding

_LUT_CACHE = {}


def base_lut(alphabet: str = ALPHABET_AGTC) -> np.ndarray:
    """256-entry byte -> digit lookup table (INVALID for other bytes).

    Lowercase bytes are INVALID, matching the reference: its k-mer map holds
    uppercase keys only (kmer_counts.py:121-122), so a lowercase window is
    skipped while the denominator keeps it.
    """
    lut = _LUT_CACHE.get(alphabet)
    if lut is None:
        lut = np.full(256, INVALID, dtype=np.int8)
        for digit, ch in enumerate(alphabet):
            lut[ord(ch)] = digit
        _LUT_CACHE[alphabet] = lut
    return lut


def encode_seq(seq: str, alphabet: str = ALPHABET_AGTC) -> np.ndarray:
    """Encode one sequence to int8 digits (INVALID where not in alphabet)."""
    raw = np.frombuffer(seq.encode("ascii", errors="replace"), dtype=np.uint8)
    return base_lut(alphabet)[raw]


def kmer_strings(k: int, alphabet: str = ALPHABET_AGTC) -> List[str]:
    """All k-mers in reference column order (product order, first char MSB)."""
    return ["".join(t) for t in itertools.product(alphabet, repeat=k)]


def pick_bucket_length(length: int, k: int, min_len: int = 256) -> int:
    """Padded length for a sequence: next power of two >= max(length, min).

    Power-of-two buckets bound the number of distinct shapes to
    O(log(max_len)) while wasting < 2x padding in the worst case.
    """
    need = max(length, k, min_len)
    padded = min_len
    while padded < need:
        padded *= 2
    return padded


@dataclass
class EncodedSeqs:
    """A set of sequences encoded and grouped into padded length buckets.

    Attributes
    ----------
    buckets : list of (bases, lengths, row_ids)
        ``bases`` is ``[rows, Lpad]`` int8 (digits 0..A-1; INVALID elsewhere,
        padding included), ``lengths`` is ``[rows]`` int32 true sequence
        lengths, ``row_ids`` maps bucket rows back to original fasta order.
    n_seqs : int
    alphabet : str
    """

    buckets: List[Tuple[np.ndarray, np.ndarray, np.ndarray]]
    n_seqs: int
    alphabet: str
    lengths: np.ndarray  # [n_seqs] original order


def _assemble_buckets(lengths, k, min_bucket_len, row_multiple,
                      max_rows_per_bucket, encode_chunk, include=None):
    """Group by padded length, pad rows to a power of two (>= ``row_multiple``),
    and fill the rows with ``encode_chunk(ids, lpad) -> [len(ids), lpad] int8``.

    ``include`` restricts assembly to those row ids (bucket row_ids stay in the
    original id space).
    """
    lengths = np.asarray(lengths)
    by_bucket = {}
    for i in (range(len(lengths)) if include is None else include):
        lpad = pick_bucket_length(int(lengths[i]), k, min_bucket_len)
        by_bucket.setdefault(lpad, []).append(int(i))

    buckets = []
    for lpad in sorted(by_bucket):
        ids = by_bucket[lpad]
        step = max_rows_per_bucket or len(ids)
        for j in range(0, len(ids), step):
            chunk = ids[j:j + step]
            rows = row_multiple
            while rows < len(chunk):
                rows *= 2
            bases = np.full((rows, lpad), INVALID, dtype=np.int8)
            bases[: len(chunk)] = encode_chunk(chunk, lpad)
            blens = np.zeros(rows, dtype=np.int32)
            blens[: len(chunk)] = lengths[chunk]
            buckets.append((bases, blens, np.asarray(chunk, dtype=np.int64)))
    return buckets


def encode_seqs(
    seqs: Sequence[str],
    k: int,
    alphabet: str = ALPHABET_AGTC,
    min_bucket_len: int = 256,
    row_multiple: int = 8,
    max_rows_per_bucket: Optional[int] = None,
) -> EncodedSeqs:
    """Encode + bucket sequences for device counting.

    Rows in each bucket are padded with zero-length dummy rows up to the next
    power of two (>= ``row_multiple``); dummy rows have length 0 and produce
    all-zero count rows, which are dropped on gather.
    """
    with span("fasta.encode"):
        lut = base_lut(alphabet)
        lengths = np.fromiter((len(s) for s in seqs), dtype=np.int32, count=len(seqs))

        buckets = _assemble_buckets(lengths, k, min_bucket_len, row_multiple,
                                    max_rows_per_bucket,
                                    _py_encode_chunk(seqs, lut))
    return EncodedSeqs(buckets=buckets, n_seqs=len(seqs), alphabet=alphabet, lengths=lengths)


def _py_encode_chunk(seqs, lut):
    """Row-chunk encoder closure for the bucket assembly."""
    def encode_chunk(ids, lpad):
        out = np.full((len(ids), lpad), INVALID, dtype=np.int8)
        for r, i in enumerate(ids):
            raw = np.frombuffer(seqs[i].encode("ascii", errors="replace"),
                                dtype=np.uint8)
            out[r, : raw.size] = lut[raw]
        return out
    return encode_chunk


_GATE_CACHE: dict = {}  # (abspath, size, mtime_ns) -> verdict


def _native_parse_is_safe(path: str) -> bool:
    """Cheap byte-level gate: may the C++ parser's output differ from the
    Python reader's?

    False on any '\\r' (Python's universal newlines treat a lone CR as a line
    break; the C++ parser splits on '\\n' only), any non-ASCII byte
    (``str.strip()`` removes Unicode whitespace the C++ byte trim keeps), a
    first non-empty line that is not a header (the C++ parser drops leading
    sequence lines), or a file that is not there.  One sequential pass over the
    raw bytes, its verdict memoized per (path, size, mtime_ns): the counter runs
    the gate twice per file (``Reader``, then ``encode_fasta``).
    """
    import os as _os

    try:
        st = _os.stat(path)
        cache_key = (_os.path.abspath(path), st.st_size, st.st_mtime_ns)
    except OSError:
        return False
    cached = _GATE_CACHE.get(cache_key)
    if cached is not None:
        return cached
    verdict = _gate_scan(path)
    if len(_GATE_CACHE) > 64:
        _GATE_CACHE.clear()
    _GATE_CACHE[cache_key] = verdict
    return verdict


def _gate_scan(path: str) -> bool:
    first_line_ok = None
    carry = b""
    try:
        with open(path, "rb") as fh:
            while True:  # chunked: no whole-file read
                chunk = fh.read(8 << 20)
                if not chunk:
                    break
                if b"\r" in chunk or not chunk.isascii():
                    return False
                if first_line_ok is None:
                    buf = carry + chunk
                    i, n = 0, len(buf)
                    while i < n:
                        j = buf.find(b"\n", i)
                        if j == -1:
                            carry = buf[i:]
                            break
                        line = buf[i:j].strip()
                        if line:
                            first_line_ok = line.startswith(b">")
                            if not first_line_ok:
                                return False
                            break
                        i = j + 1
    except OSError:
        return False
    if first_line_ok is None:  # no newline seen: judge the remainder
        first_line_ok = carry.strip().startswith(b">")
    return bool(first_line_ok)


def encode_fasta(
    path: str,
    k: int,
    alphabet: str = ALPHABET_AGTC,
    min_bucket_len: int = 256,
    row_multiple: int = 8,
    max_rows_per_bucket: Optional[int] = None,
    include_ids: Optional[Sequence[int]] = None,
) -> EncodedSeqs:
    """Encode a FASTA file into length buckets: the buckets ``encode_seqs``
    gives for the file's sequences, bit for bit.

    An AGTC file that passes ``_native_parse_is_safe`` is parsed once by the C++
    reader and each padded bucket encoded by its multithreaded batch encoder,
    with no Python string per sequence.  Another alphabet, a file the gate
    refuses, or a parse with no record or an empty sequence (where the Python
    reader's semantics must decide) takes the Python path.  ``include_ids``
    restricts the buckets to those records (row_ids stay file-order indices;
    ``lengths``/``n_seqs`` still describe the whole file): the counter keeps
    long sequences out of the buckets this way.
    """
    with span("fasta.encode"):
        return _encode_fasta(path, k, alphabet, min_bucket_len, row_multiple,
                             max_rows_per_bucket, include_ids)


def _encode_fasta(path, k, alphabet, min_bucket_len, row_multiple, max_rows_per_bucket,
                  include_ids) -> EncodedSeqs:
    if alphabet == ALPHABET_AGTC and _native_parse_is_safe(path):
        from seekr_tpu_torch import native

        with native.NativeFasta(path) as nf:
            lengths = nf.lengths().astype(np.int32)
            if len(lengths) > 0 and (lengths > 0).all():
                buckets = _assemble_buckets(lengths, k, min_bucket_len, row_multiple,
                                            max_rows_per_bucket, nf.encode_batch,
                                            include=include_ids)
                return EncodedSeqs(buckets=buckets, n_seqs=len(lengths),
                                   alphabet=alphabet, lengths=lengths)

    from seekr_tpu_torch.io.fasta import Reader

    seqs = Reader(path).get_seqs()
    if include_ids is None:
        return encode_seqs(seqs, k, alphabet, min_bucket_len=min_bucket_len,
                           row_multiple=row_multiple,
                           max_rows_per_bucket=max_rows_per_bucket)
    lengths = np.array([len(s) for s in seqs], dtype=np.int64)
    buckets = _assemble_buckets(lengths, k, min_bucket_len, row_multiple,
                                max_rows_per_bucket, _py_encode_chunk(seqs, base_lut(alphabet)),
                                include=include_ids)
    return EncodedSeqs(buckets=buckets, n_seqs=len(seqs), alphabet=alphabet,
                       lengths=lengths)
