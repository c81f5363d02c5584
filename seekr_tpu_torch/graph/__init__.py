"""Graph layer: Leiden communities over the card's Pearson matrices."""

from seekr_tpu_torch.graph.kmer_leiden import kmer_leiden

__all__ = ["kmer_leiden"]
