"""seekr_tpu_torch -- the PyTorch/CUDA port of seekr_tpu for NVIDIA Hopper.

The same public API as ``seekr_tpu`` for the count -> normalize -> Pearson path
and the statistics chain, run with PyTorch on one CUDA card:

  * FASTA reading, 2-bit encoding with length buckets, and the CSV/NPY writers
    and readers (``io``)
  * the k-mer histogram as a hand-written CUDA kernel (``ops.count_cuda``,
    sources in ``csrc/``), the normalize chain, the float32 Pearson GEMM, the
    pair gather-dot and the ECDF (``ops``)
  * ``KmerCounter``/``BasicCounter``, ``pearson`` and ``SeekrPipeline``
    (``models``)
  * ``find_dist`` -> ``find_pval`` -> ``adj_pval`` and ``multipletests``
    (``stats``)
  * the warm-resident service ``SeekrService`` and its socket server and
    client (``serve``)
  * Leiden communities with Gephi CSVs and the network plot, ``kmer_leiden``,
    and the legacy community graph ``Maker`` (``graph``)
  * the plots: heatmap, dendrogram, count and mean/sd barplots, textplots, the
    r-value distribution (``viz``; matplotlib and seaborn are imported when a
    plot draws), and the clustering's pdist on the card (``ops.dist``)
  * the one-shot workflow ``run_workflow``, the sliding-window
    ``DomainPearson`` and the PWM ``CountsWeighter`` (``models``), and the
    streamed correction ``adj_pval_stream`` (``stats.stream_adj``)
  * the data tools: GENCODE download, fasta filters, k-mer-preserving random
    RNAs (``data``); logging, traces and the ``doctor`` report (``utils``)
  * the host C++ library -- FASTA parse and encode, CSV, sorts and FDR, the
    Leiden engine -- built by g++ at first use (``native``)
  * the command line: ``python -m seekr_tpu_torch.cli <command>`` (``cli``), and
    the reference's module layout (``seekr_tpu_torch.kmer_counts``,
    ``seekr_tpu_torch.pearson``, ...) as aliases of the modules above

Entry points take ``device=None``, which means the first CUDA card; without one
they raise unless ``device="cpu"`` is asked for (``utils.device``).  The package
imports neither jax, nor seekr_tpu, nor pandas.
"""

from seekr_tpu_torch.__version__ import __version__, __title__, __description__, __license__

# Exports resolve lazily (PEP 562), so importing the package root does not
# import torch.
_LAZY_EXPORTS = {
    "KmerCounter": ("seekr_tpu_torch.models.counter", "KmerCounter"),
    "BasicCounter": ("seekr_tpu_torch.models.counter", "BasicCounter"),
    "pearson": ("seekr_tpu_torch.models.pearson", "pearson"),
    "SeekrPipeline": ("seekr_tpu_torch.models.pipeline", "SeekrPipeline"),
    "find_dist": ("seekr_tpu_torch.stats.find_dist", "find_dist"),
    "find_pval": ("seekr_tpu_torch.stats.find_pval", "find_pval"),
    "adj_pval": ("seekr_tpu_torch.stats.adj_pval", "adj_pval"),
    "multipletests": ("seekr_tpu_torch.stats.multitest", "multipletests"),
    "kmer_leiden": ("seekr_tpu_torch.graph.kmer_leiden", "kmer_leiden"),
    "Downloader": ("seekr_tpu_torch.data.gencode", "Downloader"),
    "filter_gencode": ("seekr_tpu_torch.data.filter_gencode", "filter_gencode"),
    **{name: ("seekr_tpu_torch.viz", name) for name in (
        "kmer_heatmap", "kmer_dendrogram", "kmer_count_barplot", "kmer_msd_barplot",
        "kmer_comp_textplot", "kmer_indi_textplot")},
}

__all__ = [*_LAZY_EXPORTS, "__version__"]


def __getattr__(name):
    if name in _LAZY_EXPORTS:
        import importlib

        mod, attr = _LAZY_EXPORTS[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'seekr_tpu_torch' has no attribute {name!r}")
