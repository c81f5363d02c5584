"""Reference-layout alias: `seekr.fasta` -> seekr_tpu_torch (see seekr/fasta.py).

Lets a reference user's imports keep working after `s/seekr/seekr_tpu_torch/`:
the implementation lives at the canonical path below; nothing is defined here.
"""

from seekr_tpu_torch.data.gencode import Downloader

__all__ = ['Downloader']
