"""Reference-layout alias: `seekr.kmer_counts` -> seekr_tpu_torch (see seekr/kmer_counts.py).

Lets a reference user's imports keep working after `s/seekr/seekr_tpu_torch/`:
the implementation lives at the canonical path below; nothing is defined here.
"""

from seekr_tpu_torch.models.counter import BasicCounter, KmerCounter, Log2

__all__ = ['BasicCounter', 'KmerCounter', 'Log2']
