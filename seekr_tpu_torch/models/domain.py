"""Sliding-window domain Pearson: locate query-like domains inside targets.

Port of ``seekr_tpu/models/domain.py:57-262`` (the legacy
``seekr.pearson.DomainPearson`` / ``seekr_domain_pearson`` surface), with its
contract:

  * each query transcript is profiled whole; each target is tiled into windows
    of ``window`` bases every ``slide`` bases, and every (query, window) pair
    gets a Pearson r;
  * a target shorter than ``window`` gives one window (the whole sequence);
    otherwise only full windows are tiled, so up to ``slide - 1`` trailing
    bases fall outside every window;
  * with a ``reference_path``, each r also gets a percentile (mean-rank, as
    scipy's ``percentileofscore(kind='mean')``) within that query's r against
    the reference sequences;
  * ``mean``/``std`` follow ``KmerCounter`` and apply to queries, windows and
    reference alike; left ``True`` they are computed from the reference if
    given, else from the windows;
  * under Log2.post/Log2.pre the global-min shift is taken over each counted
    set, so the window batch is the unit of normalization.

On the card: each set (the queries, all windows of all targets, the reference)
is counted in one batch by the CUDA histogram (``KmerCounter``'s
``_raw_counts_device``), normalized and correlated there; only the r-matrices
come to the host.  The returned ``r_values`` and ``percentiles`` are
``LabeledMatrix``es (rows = windows labeled ``<target>|<start>``, columns =
queries).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from seekr_tpu_torch.io.fast_csv import LabeledMatrix
from seekr_tpu_torch.io.fasta import Reader
from seekr_tpu_torch.models.counter import KmerCounter
from seekr_tpu_torch.models.pearson import pearson
from seekr_tpu_torch.ops.normalize import normalize_counts
from seekr_tpu_torch.utils.device import resolve_device
from seekr_tpu_torch.utils.logging import stage_timer


def tile_windows(seq: str, window: int, slide: int) -> List[Tuple[int, str]]:
    """(start, window string) tiles of one sequence: full windows every
    ``slide`` bases; a sequence no longer than ``window`` is one window."""
    if window <= 0 or slide <= 0:
        raise ValueError("window and slide must be positive")
    if len(seq) <= window:
        return [(0, seq)]
    return [(s, seq[s:s + window]) for s in range(0, len(seq) - window + 1, slide)]


def percentile_of_scores(null: np.ndarray, scores: np.ndarray) -> np.ndarray:
    """Percentile of each score within ``null`` (mean-rank semantics):
    ``100 * (#below + #at-or-below) / (2 * n)``, scipy's
    ``percentileofscore(null, s, kind='mean')``.  A NaN score gives a NaN
    percentile; NaN null entries are left out of the ranking."""
    null_arr = np.asarray(null, dtype=np.float64)
    null_sorted = np.sort(null_arr[~np.isnan(null_arr)])
    s = np.asarray(scores, dtype=np.float64)
    lo = np.searchsorted(null_sorted, s, side="left")
    hi = np.searchsorted(null_sorted, s, side="right")
    n = max(len(null_sorted), 1)
    out = 100.0 * (lo + hi) / (2.0 * n)
    return np.where(np.isnan(s), np.nan, out)


class DomainPearson:
    """Pearson r of query k-mer profiles against sliding windows of targets.

    query_path : fasta of query transcripts (profiled whole)
    target_path : fasta of target sequences (tiled into windows)
    reference_path : optional fasta of the percentile null (and of the
        normalization frame when ``mean``/``std`` are ``True``)
    r_values_path / percentiles_path : optional CSV artifact paths
    mean, std : ``True`` | array | ``.npy`` path | ``False``, shared by all sets
    log2 : 'Log2.pre' | 'Log2.post' | 'Log2.none'
    k, window, slide : k-mer size, window width and stride in bases
    device : where counting and the GEMMs run (default: the first CUDA card)
    """

    def __init__(self, query_path=None, target_path=None, reference_path=None,
                 r_values_path=None, percentiles_path=None, mean=True, std=True,
                 log2="Log2.post", k=6, window=1000, slide=100, device=None):
        self.query_path = query_path
        self.target_path = target_path
        self.reference_path = reference_path
        self.r_values_path = r_values_path
        self.percentiles_path = percentiles_path
        self.mean = np.load(mean) if isinstance(mean, str) else mean
        self.std = np.load(std) if isinstance(std, str) else std
        self.log2 = log2
        self.k = int(k)
        self.window = int(window)
        self.slide = int(slide)
        self.device = resolve_device(device)

        self.query_names: List[str] = []
        self.target_names: List[str] = []
        self.window_labels: List[str] = []
        self.r_values = None      # LabeledMatrix [n_windows, n_queries]
        self.percentiles = None   # the same shape, with a reference

    # -- internals ---------------------------------------------------------

    def _raw_for(self, seqs: Sequence[str]):
        """Raw counts-per-kb of in-memory sequences: one batch on the device,
        normalized apart so that no set is counted twice."""
        counter = KmerCounter(k=self.k, mean=False, std=False, log2="Log2.none",
                              silent=True, device=self.device)
        counter.seqs = list(seqs)
        return counter._raw_counts_device()

    def _normalized(self, raw, mean, std):
        """The shared normalization frame applied to a raw count tensor."""
        out, _, _ = normalize_counts(raw, log2_mode=self.log2, mean=mean, std=std)
        return out

    @staticmethod
    def _short_name(header: str) -> str:
        """Row/column label: the fasta header up to its first '|'."""
        name = header.lstrip(">").split("|")[0].strip()
        return name or header.lstrip(">")

    # -- public API --------------------------------------------------------

    def split_targets(self):
        """Tile every target into windows; sets ``window_labels`` and returns
        the window strings."""
        reader = Reader(self.target_path)
        seqs = reader.get_seqs()
        raw_names = [self._short_name(h) for h in reader.get_headers()]
        # two targets sharing a short name would mint identical window labels:
        # the later ones get '.1', '.2', ... as pandas mangles duplicates
        seen: dict = {}
        self.target_names = []
        for n in raw_names:
            c = seen.get(n, 0)
            seen[n] = c + 1
            self.target_names.append(n if c == 0 else f"{n}.{c}")
        labels, window_seqs = [], []
        for name, seq in zip(self.target_names, seqs):
            for start, wseq in tile_windows(seq, self.window, self.slide):
                labels.append(f"{name}|{start}")
                window_seqs.append(wseq)
        self.window_labels = labels
        return window_seqs

    def run(self) -> LabeledMatrix:
        """Count, correlate, rank (with a reference) and write the artifacts.

        Returns the r-values ([windows x queries]); also sets ``r_values`` and,
        with a reference fasta, ``percentiles``.
        """
        qreader = Reader(self.query_path)
        query_seqs = qreader.get_seqs()
        self.query_names = [self._short_name(h) for h in qreader.get_headers()]
        window_seqs = self.split_targets()
        ref_seqs = Reader(self.reference_path).get_seqs() if self.reference_path else None
        if self.percentiles_path and ref_seqs is None:
            print("WARNING: --percentiles_path was given without "
                  "--reference; percentiles need a reference null "
                  "distribution, so no percentiles file will be written.")

        with stage_timer("domain_pearson", items=len(window_seqs), unit="windows"):
            query_raw = self._raw_for(query_seqs)
            window_raw = self._raw_for(window_seqs)
            ref_raw = self._raw_for(ref_seqs) if ref_seqs is not None else None

            mean, std = self.mean, self.std
            basis_norm = basis = None
            if mean is True or std is True:
                basis = ref_raw if ref_raw is not None else window_raw
                if std is True and basis.shape[0] == 1:
                    raise ValueError(
                        "You cannot standardize a single sequence. "
                        "Please pass the path to an std. dev. array, "
                        "or use raw counts by setting std=False.")
                basis_norm, bmean, bstd = normalize_counts(
                    basis, log2_mode=self.log2, mean=mean, std=std)
                if mean is True:
                    mean = bmean.cpu().numpy()
                if std is True:
                    std = bstd.cpu().numpy()

            def normalized(raw):
                # deriving the vectors already normalized the basis set
                return basis_norm if raw is basis else self._normalized(raw, mean, std)

            query_counts = normalized(query_raw)
            window_counts = normalized(window_raw)
            r = pearson(window_counts, query_counts, device=self.device)

        self.r_values = LabeledMatrix(r, self.window_labels, self.query_names)
        if self.r_values_path:
            self.r_values.to_csv(self.r_values_path)

        if ref_seqs is not None:
            null = pearson(query_counts, normalized(ref_raw), device=self.device)
            pct = np.empty_like(r)
            for j in range(r.shape[1]):
                pct[:, j] = percentile_of_scores(null[j], r[:, j])
            self.percentiles = LabeledMatrix(pct, self.window_labels, self.query_names)
            if self.percentiles_path:
                self.percentiles.to_csv(self.percentiles_path)

        return self.r_values
