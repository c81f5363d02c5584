"""Reference-layout alias: `seekr.fasta_reader` -> seekr_tpu_torch (see seekr/fasta_reader.py).

Lets a reference user's imports keep working after `s/seekr/seekr_tpu_torch/`:
the implementation lives at the canonical path below; nothing is defined here.
"""

from seekr_tpu_torch.io.fasta import Reader

__all__ = ['Reader']
