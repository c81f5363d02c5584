"""KmerCounter -- the reference BasicCounter, counting on a CUDA card.

Port of ``seekr_tpu/models/counter.py``: the same constructor, attributes and
error messages, with counting and normalization on ``device``:

  FASTA -> 2-bit encode + length buckets (host)   seekr_tpu_torch.io.encode
        -> k-mer histogram (CUDA kernel)          seekr_tpu_torch.ops.count
        -> normalize chain (device)               seekr_tpu_torch.ops.normalize
        -> float32 numpy matrix + .npy artifact (host)

Deviations from the reference are seekr_tpu's: integer window counts scaled once
by 1000/(len-k+1); a sequence shorter than k gives a zero row; a non-4-letter
alphabet counts on the host.  A FASTA file is parsed and encoded by the host C++
library where ``io.encode.encode_fasta`` allows it, giving the buckets the Python
encode gives, bit for bit.  ``save`` writes the reference's three forms:
``.npy``, labeled CSV and raw ``'%1.6f'`` CSV (``io.fast_csv``).
"""

from __future__ import annotations

import numpy as np
import torch

from seekr_tpu_torch.io.encode import encode_fasta, encode_seq, encode_seqs, kmer_strings
from seekr_tpu_torch.io.fast_csv import write_labeled_csv, write_raw_csv
from seekr_tpu_torch.io.fasta import Reader
from seekr_tpu_torch.ops.count import (count_kmers_device, count_kmers_host,
                                       count_kmers_long)
from seekr_tpu_torch.ops.normalize import LOG2_MODES, normalize_counts
from seekr_tpu_torch.utils.device import resolve_device


class Log2:
    """String-valued stand-in for the reference's (commented-out) Log2 enum."""

    pre = "Log2.pre"
    post = "Log2.post"
    none = "Log2.none"


# Rows per encode bucket, as in seekr_tpu (bases [2048, L<=16384] int8 <= 32 MB).
_MAX_ROWS_PER_BUCKET = 2048

# Sequences longer than this are counted in chunks (ops.count.count_kmers_long)
# instead of padding a power-of-two bucket to their full length.
_LONG_SEQ_THRESHOLD = 16384


class KmerCounter:
    """Generates overlapping k-mer counts for a fasta file on a CUDA card.

    Parameters mirror the reference BasicCounter (seekr/kmer_counts.py:48-101):

    infasta: str (default=None)            path to fasta to count
    outfile: str (default=None)            where to save counts (.npy)
    k: int (default=6)                     k-mer size
    binary: bool (default=True)            .npy if True, else CSV
    mean: bool | np.ndarray | str          center columns (str = .npy path)
    std: bool | np.ndarray | str           standardize columns (str = .npy path)
    log2: str (default='Log2.post')        'Log2.pre' | 'Log2.post' | 'Log2.none'
    leave, silent: tqdm controls (tqdm is imported only when not silent)
    label: bool (default=False)            labeled csv output
    alphabet: str (default='AGTC')         valid letters (column order = product)
    min_bucket_len: int (default=256)      floor of the power-of-two buckets
    device: where counting runs; ``None`` is the first CUDA card
    """

    def __init__(self, infasta=None, outfile=None, k=6, binary=True, mean=True,
                 std=True, log2="Log2.post", leave=True, silent=False,
                 label=False, alphabet="AGTC", min_bucket_len=256, device=None):
        self.infasta = infasta
        self.seqs = None
        self.headers = None
        if infasta is not None:
            reader = Reader(infasta)
            self.seqs = reader.get_seqs()
            self.headers = reader.get_headers()
        # the file path is taken only while ``seqs`` is the list parsed here,
        # unchanged: the snapshot holds the same string objects, so ``==`` is
        # O(m) pointer compares and still catches an edit in place
        self._file_seqs = self.seqs
        self._file_seqs_snapshot = list(self.seqs) if self.seqs else None
        self.outfile = outfile
        self.k = int(k)
        self.binary = binary
        self.mean = np.load(mean) if isinstance(mean, str) else mean
        self.std = np.load(std) if isinstance(std, str) else std
        self.log2 = log2
        self.leave = leave
        self.silent = silent
        self.label = label
        self.counts = None
        self.min_bucket_len = int(min_bucket_len)
        self.alphabet = alphabet
        self.alpha_len = len(alphabet)
        self.kmers = kmer_strings(self.k, alphabet)
        self.map = {kmer: i for i, kmer in enumerate(self.kmers)}
        self.device = resolve_device(device)

        if self.seqs is not None and len(self.seqs) == 1 and self.std is True:
            raise ValueError(
                "You cannot standardize a single sequence. "
                "Please pass the path to an std. dev. array, "
                "or use raw counts by setting std=False.")
        if self.log2 not in LOG2_MODES:
            raise ValueError("log2 must be one of ['Log2.pre', 'Log2.post', 'Log2.none']")

    # -- counting ----------------------------------------------------------

    def occurrences(self, row, seq):
        """Count k-mers of one sequence on a per-kilobase scale into ``row``.

        Kept for API parity with the reference (kmer_counts.py:140-151).
        """
        counts = count_kmers_host([seq], self.k, self.alphabet)[0]
        hit = np.nonzero(counts > 0)[0]
        if isinstance(row, np.ndarray):
            row[hit] = counts[hit]
        else:
            for i in hit:
                row[int(i)] = float(counts[i])
        return row

    def _encode_from_file(self, include_ids=None):
        """``encode_fasta`` of ``infasta``, or None when the file no longer
        holds the records parsed at construction (counting reflects
        ``self.seqs``, never a later state of the file; a rewrite that keeps
        every length is not detected)."""
        try:
            encoded = encode_fasta(self.infasta, self.k, self.alphabet,
                                   min_bucket_len=self.min_bucket_len,
                                   max_rows_per_bucket=_MAX_ROWS_PER_BUCKET,
                                   include_ids=include_ids)
        except (OSError, IndexError, ValueError):
            # IndexError/ValueError: include_ids indexed into a file that shrank
            return None
        if encoded.n_seqs != len(self.seqs) or not np.array_equal(
                np.asarray(encoded.lengths), [len(s) for s in self.seqs]):
            return None
        return encoded

    def _raw_counts_device(self) -> torch.Tensor:
        """Raw counts-per-kb matrix [m, alpha_len**k] float32 on the device."""
        dev = self.device
        m = len(self.seqs)
        n_cols = self.alpha_len ** self.k
        if self.alpha_len != 4:
            return torch.as_tensor(count_kmers_host(self.seqs, self.k, self.alphabet),
                                   device=dev)

        # (dest row ids, device block) pairs covering all m rows; dest id m is a
        # pad row, which lands on the trash row of the assembly buffer
        parts = []
        long_ids = [i for i, s in enumerate(self.seqs) if len(s) > _LONG_SEQ_THRESHOLD]
        if long_ids:
            rows = np.stack([count_kmers_long(encode_seq(self.seqs[i], self.alphabet),
                                              self.k, device=dev)
                             for i in long_ids])
            parts.append((np.asarray(long_ids, dtype=np.int64),
                          torch.as_tensor(rows, device=dev)))

        long_set = set(long_ids)
        short_ids = [i for i in range(m) if i not in long_set]
        if short_ids:
            encoded, id_map = None, None
            if (self.infasta is not None and self.seqs is self._file_seqs
                    and self.seqs == self._file_seqs_snapshot):
                # long rows, if any, are left out but keep file-order row ids
                encoded = self._encode_from_file(short_ids if long_ids else None)
            if encoded is None:
                encoded = encode_seqs([self.seqs[i] for i in short_ids], self.k,
                                      self.alphabet, min_bucket_len=self.min_bucket_len,
                                      max_rows_per_bucket=_MAX_ROWS_PER_BUCKET)
                id_map = np.asarray(short_ids, dtype=np.int64)
            buckets = encoded.buckets
            if not self.silent:
                from tqdm import tqdm

                buckets = tqdm(buckets, desc="Kmers", leave=self.leave)
            for bases, lengths, row_ids in buckets:
                res = count_kmers_device(bases, lengths, self.k, device=dev)
                dest = np.full(res.shape[0], m, dtype=np.int64)
                dest[: len(row_ids)] = row_ids if id_map is None else id_map[row_ids]
                parts.append((dest, res))

        if not parts:
            return torch.zeros((m, n_cols), dtype=torch.float32, device=dev)
        if len(parts) == 1 and parts[0][1].shape[0] == m \
                and np.array_equal(parts[0][0], np.arange(m)):
            return parts[0][1]  # already whole and in file order
        # Restore file order: each block is copied into its rows of an [m+1, n]
        # buffer, block by block (no concatenated copy of all blocks).  Every
        # index is in range: pad rows go to the trash row m, sliced off after.
        out = torch.zeros((m + 1, n_cols), dtype=torch.float32, device=dev)
        for dest, block in parts:
            out.index_copy_(0, torch.as_tensor(dest, device=dev), block)
        return out[:m]

    def get_counts_device(self, nan_check: bool = True) -> torch.Tensor:
        """Normalized counts as a device tensor, without a host round trip.

        Same math and warning as ``get_counts`` (which is this plus one fetch);
        ``self.counts`` is not set.  ``nan_check=False`` skips the NaN probe,
        a scalar fetch that waits for the device.
        """
        raw = self._raw_counts_device()
        counts, mean, std = normalize_counts(raw, log2_mode=self.log2,
                                             mean=self.mean, std=self.std)
        if self.mean is True and mean is not None:
            self.mean = mean.cpu().numpy()
        if self.std is True and std is not None:
            self.std = std.cpu().numpy()
        if nan_check and self.std is not False and bool(torch.isnan(counts).any()):
            print(
                "\nWARNING: You have `np.nan` values in your counts "
                "after standardization. This is likely due to "
                "a kmer not appearing in any of your sequences. "
                "Try: \n1) using a smaller kmer size, \n2) beginning "
                "with a larger set of sequences, \n3) passing "
                "precomputed normalization vectors from a larger "
                "data set (e.g. GENCODE)."
            )
        return counts

    def get_counts(self) -> np.ndarray:
        """Generate the (normalized) count matrix for the fasta file."""
        self.counts = self.get_counts_device().cpu().numpy()
        return self.counts

    # -- persistence --------------------------------------------------------

    def save(self, names=None):
        """Save counts: binary .npy | labeled csv | raw %1.6f csv.

        The reference's kmer_counts.py:211-241 byte for byte, including the
        '>'-prefixed fasta headers as csv row labels.
        """
        err_msg = (
            "You cannot label a binary file. "
            'Set only one of "binary" or "label" as True. '
            "If you used `-b` from the command line, "
            "try also using `-rl`."
        )
        assert not (self.binary and self.label), err_msg
        assert self.outfile is not None, "Please provide an outfile location."
        if self.binary:
            np.save(self.outfile, self.counts)
        elif self.label:
            write_labeled_csv(self.outfile, self.counts,
                              self.headers if names is None else names, self.kmers)
        else:
            write_raw_csv(self.outfile, self.counts)

    def make_count_file(self, names=None):
        """get_counts + save (if outfile set); returns the counts matrix."""
        self.get_counts()
        if self.outfile is not None:
            self.save(names)
        return self.counts


# Reference-compatible alias
BasicCounter = KmerCounter


def make_count_file(infasta, outfile, k=6, **kwargs):
    return KmerCounter(infasta=infasta, outfile=outfile, k=k, **kwargs).make_count_file()
