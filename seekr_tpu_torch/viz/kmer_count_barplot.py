"""Grouped barplot of normalized k-mer counts for up to 10 sequences.

Port of ``seekr_tpu/viz/kmer_count_barplot.py`` (behavioural parity with
seekr/kmer_count_barplot.py:57-160): counts by the port's ``KmerCounter`` (the
CUDA count kernel on a card), k-mer columns ordered by their summed
|difference from the column mean|, melted to long form, and a seaborn grouped
barplot of the first ``topkmernumber`` words per sequence.  ``_barplot_rows`` is
the compute half, callable without matplotlib or seaborn.
"""

from __future__ import annotations

from seekr_tpu_torch.viz import long_form
from seekr_tpu_torch.viz.style import (check_norm_compat, ensure_headless_backend,
                                       save_figure, setup_fonts)


def _barplot_rows(headers, counts, kmers, sortmethod, topkmernumber):
    """The long-form columns seaborn draws, with the reference's messages."""
    if len(headers) > 10:
        print("There are more than 10 input sequences, "
              "only plot the first 10 sequences")
        headers = headers[:10]
        counts = counts[:10]
    if sortmethod not in ("ascending", "descending"):
        print("Please choose a sorting method: 'ascending' or 'descending', "
              "use default 'ascending' now")
        sortmethod = "ascending"
    order = long_form.sort_order(long_form.abs_deviation_sum(counts),
                                 ascending=(sortmethod == "ascending"))
    return long_form.plot_rows(counts, headers, kmers, order, topkmernumber)


def kmer_count_barplot(inputfile, mean, std, k, log2="Log2.post",
                       sortmethod="ascending", topkmernumber=10,
                       xlabelsize=20, ylabelsize=20, xticksize=20,
                       yticksize=20, legendsize=12,
                       outputname="test_kmer_count_barplot", pformat="pdf",
                       pdpi=300, device=None):
    """seekr_tpu's ``kmer_count_barplot`` plus ``device``, where the counting
    runs (``None`` = the first CUDA card)."""
    ensure_headless_backend()
    import matplotlib.pyplot as plt
    import seaborn as sns

    if not check_norm_compat(mean, std, k, "barplot is plotted"):
        return None
    headers, counts, kmers = long_form.counted_profiles(inputfile, mean, std, k, log2,
                                                        device)
    df_plot = _barplot_rows(headers, counts, kmers, sortmethod, topkmernumber)

    plt.figure(figsize=(topkmernumber * 2, 8))
    setup_fonts()
    sns.barplot(x="Kword", y="Value", hue="Sample", data=df_plot, palette="tab10")
    plt.xlabel("Kmer Words", fontsize=xlabelsize)
    plt.ylabel("z-score (transformed or raw)", fontsize=ylabelsize)
    plt.xticks(rotation=90, fontsize=xticksize)
    plt.yticks(fontsize=yticksize)
    plt.legend(loc="center left", bbox_to_anchor=(1, 0.5), fontsize=legendsize)
    save_figure(outputname, pformat, pdpi)
    plt.close("all")
