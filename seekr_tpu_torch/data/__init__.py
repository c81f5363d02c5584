"""Data acquisition and preparation: GENCODE download, fasta filters and
k-mer-preserving random RNAs (host code)."""

from seekr_tpu_torch.data.canonical import canonical_gencode
from seekr_tpu_torch.data.filter_gencode import filter_gencode
from seekr_tpu_torch.data.gencode import Downloader
from seekr_tpu_torch.data.rand_rnas import RandomMaker, gen_rand_rnas

__all__ = ["Downloader", "filter_gencode", "RandomMaker", "gen_rand_rnas",
           "canonical_gencode"]
