"""Weight k-mer count profiles by protein-binding motif PWMs.

Port of ``seekr_tpu/models/pwm.py:34-142`` (the legacy ``seekr.pwm.CountsWeighter``
/ ``seekr_pwms`` surface), without pandas.  A position-weight matrix (PWM)
gives per-position base probabilities of a binding motif.  A k-mer's weight is
the sum, over every alignment of the k-mer inside the motif, of the product of
the matched bases' probabilities; a sequence's score for the motif is its count
row dotted with the weight vector.  Scoring every sequence against every PWM is
``counts [m, 4^k] @ weights [4^k, n_pwms]`` in float64 on the host: PWM
collections are small and the weights are built from dictionaries.
"""

from __future__ import annotations

import csv
from collections import defaultdict
from itertools import product
from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from seekr_tpu_torch.io.fast_csv import LabeledMatrix, read_labeled_csv


class CountsWeighter:
    """Score k-mer count profiles against a directory of PWM files.

    pwm_dir : directory of tab-separated PWM files (columns ``Pos``, ``A``,
        ``C``, ``G``, ``U``/``T``; one row per motif position)
    counts : k-mer counts: a ``.npy`` or labeled CSV path, an ndarray, a
        ``LabeledMatrix`` or any object with ``.values/.index/.columns``
    k : k-mer size of the counts' columns
    out_path : optional CSV path for the scores written by :meth:`run`
    """

    def __init__(self, pwm_dir: Optional[str] = None, counts=None, k: int = 5,
                 out_path: Optional[str] = None):
        self.pwm_dir = pwm_dir
        self.k = k
        self.out_path = out_path
        # AGTC product order: the counting pipeline's column order
        self.kmers = ["".join(p) for p in product("AGTC", repeat=k)]
        self.counts = None if counts is None else self.get_counts(counts)
        self.df: Optional[LabeledMatrix] = None

    def get_counts(self, counts) -> LabeledMatrix:
        """The counts as a ``LabeledMatrix``: a labeled CSV keeps its labels;
        an array (or ``.npy``) gets rows 0..m-1 and the k-mer columns."""
        if isinstance(counts, str):
            if not counts.endswith(".npy"):
                # column-major, as pandas' read_csv holds it: the product's
                # summation order follows the layout, and with it the last bits
                m = read_labeled_csv(counts)
                return LabeledMatrix(np.asfortranarray(m.values), m.index, m.columns)
            counts = np.load(counts)
        if isinstance(counts, LabeledMatrix):
            return counts
        if all(hasattr(counts, a) for a in ("values", "index", "columns")):
            return LabeledMatrix(np.asarray(counts.values), counts.index, counts.columns)
        counts = np.asarray(counts)
        return LabeledMatrix(counts, range(counts.shape[0]), self.kmers)

    def gen_pwm_dicts(self) -> Iterator[Tuple[Path, Dict]]:
        """Yield (path, {base: {position index: probability}}) per PWM file,
        ``U`` read as ``T`` and the ``Pos`` column dropped."""
        if self.pwm_dir is None:
            raise ValueError("pwm_dir is required to iterate PWM files")
        for path in sorted(Path(self.pwm_dir).glob("*.txt")):
            with open(path, newline="") as fh:
                rows = list(csv.reader(fh, delimiter="\t"))
            header = ["T" if name == "U" else name for name in rows[0]]
            table = {name: {} for name in header if name != "Pos"}
            for i, row in enumerate(rows[1:]):
                for name, cell in zip(header, row):
                    if name != "Pos":
                        table[name][i] = float(cell)
            yield path, table

    @staticmethod
    def set_kmer2weight(kmer2weight: Dict, pwm: Dict, sub_kmer: str,
                        kmer: str, window: int) -> None:
        """Add ``sub_kmer``'s summed alignment products to ``kmer``'s weight:
        for every offset of a ``window``-long word inside the motif, the
        product of the matched per-position probabilities."""
        n_positions = len(pwm[sub_kmer[0]])
        for start in range(n_positions - window + 1):
            weight = 1.0
            for i in range(window):
                weight *= pwm[sub_kmer[i]][start + i]
            kmer2weight[kmer] += weight

    def build_weights_dict(self, pwm: Dict) -> Dict[str, float]:
        """The weight of every k-mer against one PWM.  When the motif is
        shorter than k, every ``window``-long sub-word of the k-mer is scored
        against the whole motif instead."""
        n_positions = len(pwm["A"])
        window = min(self.k, n_positions)
        kmer2weight: Dict[str, float] = defaultdict(int)
        for kmer in self.kmers:
            for start in range(self.k - window + 1):
                self.set_kmer2weight(kmer2weight, pwm, kmer[start:start + window],
                                     kmer, window)
        return kmer2weight

    def weight_counts(self, kmer2weight: Dict[str, float]) -> np.ndarray:
        """Per-sequence motif score: count row . weight vector (float64)."""
        weights = np.array([kmer2weight[kmer] for kmer in self.counts.columns])
        return self.counts.values @ weights

    def run(self) -> LabeledMatrix:
        """Score every sequence against every PWM in ``pwm_dir``.

        Returns (and stores as ``self.df``) one row per PWM file and one column
        per sequence (numbered 0..m-1, as seekr_tpu's frame is); written to
        ``out_path`` as CSV when set.
        """
        if self.counts is None:
            raise ValueError("counts are required to run the weighting")
        # counts of another k would miss every weight and score 0 silently
        kmer_set = set(self.kmers)
        unknown = [c for c in self.counts.columns if c not in kmer_set]
        if unknown:
            raise ValueError(
                f"counts columns do not match k={self.k} k-mers (e.g. "
                f"{unknown[0]!r}); pass the k the counts artifact was built with")
        names, scores = [], []
        for path, pwm in self.gen_pwm_dicts():
            names.append(path.name)
            scores.append(self.weight_counts(self.build_weights_dict(pwm)))
        m = self.counts.shape[0]
        values = np.stack(scores) if scores else np.empty((0, m))
        self.df = LabeledMatrix(values, names, range(m))
        if self.out_path:
            self.df.to_csv(self.out_path)
        return self.df
