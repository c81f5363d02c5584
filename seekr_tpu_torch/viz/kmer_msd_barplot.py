"""Mean +/- sd barplot of k-mer counts across sequences.

Port of ``seekr_tpu/viz/kmer_msd_barplot.py`` (behavioural parity with
seekr/kmer_msd_barplot.py:59-171): counts by the port's ``KmerCounter`` (the
CUDA count kernel on a card), each k-mer's mean or sample sd across sequences
as the sort key, and a seaborn barplot with sd error bars.  ``_msd_rows`` is
the compute half, callable without matplotlib or seaborn.
"""

from __future__ import annotations

from seekr_tpu_torch.viz import long_form
from seekr_tpu_torch.viz.style import (check_norm_compat, ensure_headless_backend,
                                       save_figure, setup_fonts)


def _msd_rows(headers, counts, kmers, sortstat, sortmethod, topkmernumber):
    """The long-form columns seaborn draws, with the reference's messages."""
    if sortstat not in ("mean", "sd"):
        print("Please choose a sorting stat: 'mean' or 'sd', use default "
              "'mean' and default sortmethod'descending' now")
        sortstat, sortmethod = "mean", "descending"
    if sortmethod not in ("ascending", "descending"):
        print("Please choose a sorting method: 'ascending' or 'descending', "
              "use default 'descending' now")
        sortmethod = "descending"
    stat = (long_form.column_mean(counts) if sortstat == "mean"
            else long_form.column_sd(counts))
    order = long_form.sort_order(stat, ascending=(sortmethod == "ascending"))
    return long_form.plot_rows(counts, headers, kmers, order, topkmernumber)


def kmer_msd_barplot(inputfile, mean, std, k, log2="Log2.post",
                     sortstat="mean", sortmethod="descending",
                     topkmernumber=10, xlabelsize=20, ylabelsize=20,
                     xticksize=20, yticksize=20,
                     outputname="test_kmer_msd_barplot", pformat="pdf",
                     pdpi=300, device=None):
    """seekr_tpu's ``kmer_msd_barplot`` plus ``device``, where the counting runs
    (``None`` = the first CUDA card)."""
    ensure_headless_backend()
    import matplotlib.pyplot as plt
    import seaborn as sns

    if not check_norm_compat(mean, std, k, "barplot is plotted"):
        return None
    headers, counts, kmers = long_form.counted_profiles(inputfile, mean, std, k, log2,
                                                        device)
    df_plot = _msd_rows(headers, counts, kmers, sortstat, sortmethod, topkmernumber)

    plt.figure(figsize=(topkmernumber * 2, 8))
    setup_fonts()
    sns.barplot(x="Kword", y="Value", hue="Kword", data=df_plot,
                palette="tab10", errorbar="sd", capsize=0.2, legend=False)
    plt.xlabel("Kmer Words", fontsize=xlabelsize)
    plt.ylabel("z-score (transformed or raw)", fontsize=ylabelsize)
    plt.xticks(rotation=90, fontsize=xticksize)
    plt.yticks(fontsize=yticksize)
    save_figure(outputname, pformat, pdpi)
    plt.close("all")
