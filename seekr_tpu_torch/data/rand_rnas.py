"""k-mer-preserving random RNA generation (the legacy ``seekr_gen_rand_rnas``).

Port of ``seekr_tpu/data/rand_rnas.py``, with the same generator calls in the
same order, so that one seed gives seekr_tpu's sequences.  Useful for null or
background corpora whose k-mer composition matches a real transcriptome.

* ``k=1``: a plain uniform shuffle of the characters.
* ``k>=2``: an Altschul-Erickson shuffle: the result has EXACTLY the k-mer
  multiset (and so the first and last (k-1)-mer) of the input.  It is a random
  Eulerian path of the (k-1)-mer de Bruijn multigraph: a spanning arborescence
  toward the end vertex drawn by rejection, the other out-edges permuted
  uniformly.
* ``mutations=m``: after shuffling, m distinct positions get a different
  letter (Hamming distance exactly min(m, len)).
* ``group=True``: all sequences are concatenated, shuffled as one and split
  back to the original lengths, preserving the pooled k-mer content.

Host code: a per-sequence graph walk with data-dependent control flow.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from seekr_tpu_torch.io.fasta import Reader


class RandomMaker:
    """Generate k-mer-content-preserving shuffles of FASTA sequences.

    Parameters
    ----------
    infasta, outfasta : paths for :meth:`synthesize_random`
    k : size of the preserved k-mers (1 = composition only)
    mutations : number of random substitutions applied after shuffling
    seed : RNG seed for reproducible output
    group : shuffle the pooled concatenation instead of each sequence
    """

    def __init__(self, infasta: Optional[str] = None,
                 outfasta: Optional[str] = None, k: int = 1,
                 mutations: int = 0, seed: Optional[int] = None,
                 group: bool = False):
        if k < 1:
            raise ValueError("k must be >= 1")
        if mutations < 0:
            raise ValueError("mutations must be >= 0")
        self.infasta = infasta
        self.outfasta = outfasta
        self.k = k
        self.mutations = mutations
        self.group = group
        self.rng = np.random.default_rng(seed)
        self.seqs: List[str] = []
        self.names: List[str] = []
        if infasta is not None:
            reader = Reader(infasta)
            self.seqs = reader.get_seqs()
            self.names = reader.get_headers()

    # ------------------------------------------------------------- shuffle

    def shuffle(self, seq: str) -> str:
        """One k-mer-preserving shuffle of ``seq`` (+ optional mutations)."""
        if len(seq) > self.k:
            if self.k == 1:
                chars = np.array(list(seq))
                self.rng.shuffle(chars)
                shuffled = "".join(chars)
            else:
                shuffled = self._euler_shuffle(seq)
        else:
            shuffled = seq
        if self.mutations:
            shuffled = self._mutate(shuffled)
        return shuffled

    def _euler_shuffle(self, seq: str) -> str:
        """Altschul-Erickson shuffle preserving the exact k-mer multiset."""
        km1 = self.k - 1
        # vertices are (k-1)-mers; edge i is the k-mer at position i,
        # recorded as (target vertex)
        verts = [seq[i:i + km1] for i in range(len(seq) - km1 + 1)]
        start, end = verts[0], verts[-1]
        adj = {}
        for i in range(len(verts) - 1):
            adj.setdefault(verts[i], []).append(verts[i + 1])
        if all(len(set(targets)) == 1 for targets in adj.values()):
            return seq  # one outgoing direction everywhere: unique walk

        vertices = list(adj)
        # draw a spanning arborescence toward `end`: pick one candidate
        # "last edge" per non-end vertex, accept iff every vertex reaches
        # `end` by following them (rejection sampling; the graph is
        # end-reachable by construction, so acceptance is likely)
        for _ in range(10_000):
            last = {v: adj[v][self.rng.integers(len(adj[v]))]
                    for v in vertices if v != end}
            ok = True
            for v in vertices:
                if v == end:
                    continue
                hops, node = 0, v
                while node != end and node in last and hops <= len(vertices):
                    node = last[node]
                    hops += 1
                if node != end:
                    ok = False
                    break
            if ok:
                break
        else:  # pragma: no cover — rejection virtually always succeeds
            return seq

        # per-vertex edge order: random permutation of the non-last edges,
        # with the arborescence edge forced last
        order = {}
        for v in vertices:
            edges = list(adj[v])
            if v != end:
                edges.remove(last[v])
            self.rng.shuffle(edges)
            if v != end:
                edges.append(last[v])
            order[v] = edges

        out = [start]
        pos = {v: 0 for v in vertices}
        node = start
        total_edges = len(verts) - 1
        for _ in range(total_edges):
            nxt = order[node][pos[node]]
            pos[node] += 1
            out.append(nxt[-1])
            node = nxt
        return "".join(out)

    def _mutate(self, seq: str, alphabet: str = "AGTC") -> str:
        n = min(self.mutations, len(seq))
        positions = self.rng.choice(len(seq), size=n, replace=False)
        chars = list(seq)
        for p in sorted(positions):
            others = [c for c in alphabet if c != chars[p]] or list(alphabet)
            chars[p] = others[self.rng.integers(len(others))]
        return "".join(chars)

    # ------------------------------------------------------------ batching

    def get_random_seqs(self, seqs: Sequence[str]) -> List[str]:
        """Shuffle each sequence independently."""
        return [self.shuffle(s) for s in seqs]

    def split(self, seq: str) -> List[str]:
        """Split a pooled shuffle back into the stored sequences' lengths."""
        out, at = [], 0
        for s in self.seqs:
            out.append(seq[at:at + len(s)])
            at += len(s)
        return out

    def inject_seqs(self, new_seqs: Sequence[str]) -> List[str]:
        """Interleave stored headers with new sequences (FASTA line list)."""
        lines = []
        for name, seq in zip(self.names, new_seqs):
            lines.append(name)
            lines.append(seq)
        return lines

    def synthesize_random(self) -> None:
        """Write ``outfasta``: shuffled versions of ``infasta``'s sequences."""
        if self.infasta is None or self.outfasta is None:
            raise ValueError("synthesize_random requires infasta and outfasta")
        if self.group:
            pooled = self.shuffle("".join(self.seqs))
            new_seqs = self.split(pooled)
        else:
            new_seqs = self.get_random_seqs(self.seqs)
        with open(self.outfasta, "w") as fh:
            fh.write("\n".join(self.inject_seqs(new_seqs)) + "\n")


def gen_rand_rnas(infasta: str, outfasta: str, k: int = 1, mutations: int = 0,
                  seed: Optional[int] = None, group: bool = False) -> None:
    """Generate a k-mer-content-preserving shuffled FASTA (legacy CLI API)."""
    RandomMaker(infasta, outfasta, k=k, mutations=mutations, seed=seed,
                group=group).synthesize_random()
