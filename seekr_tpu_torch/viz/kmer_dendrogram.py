"""Row or column hierarchical-clustering dendrogram.

Port of ``seekr_tpu/viz/kmer_dendrogram.py`` (behavioural parity with
seekr/kmer_dendrogram.py:49-139): pdist -> linkage -> scipy's dendrogram with
labels, distance_sort and 90-degree leaf labels.  The pdist runs on the card
above ``ops.dist``'s size threshold.  ``_dendrogram_linkage`` is the compute
half, callable without matplotlib.
"""

from __future__ import annotations

from seekr_tpu_torch.viz.style import ensure_headless_backend, save_figure, setup_fonts


def _dendrogram_linkage(df, dendro_direct="row", distmetric="correlation",
                        linkmethod="complete", device=None):
    """(linkage, labels, leaf count) of the rows or columns of a labeled matrix
    (``values``/``index``/``columns``), or None with the reference's message
    when ``dendro_direct`` is neither."""
    from scipy.cluster.hierarchy import linkage

    from seekr_tpu_torch.ops.dist import pdist_auto

    if dendro_direct == "row":
        data, labels = df.values, df.index
    elif dendro_direct == "column":
        data, labels = df.values.T, df.columns
    else:
        print("dendro_direct must be either 'row' or 'column'. "
              "Please check and rerun.")
        return None
    link = linkage(pdist_auto(data, metric=distmetric, device=device), linkmethod)
    return link, list(labels), data.shape[0]


def kmer_dendrogram(df, dendro_direct="row", distmetric="correlation",
                    linkmethod="complete", plot_ht=8, wd_ratio=0.5,
                    leaf_font_size=16, outputname="test_kmer_dendrogram",
                    pformat="pdf", pdpi=300, device=None):
    """seekr_tpu's ``kmer_dendrogram`` on a ``LabeledMatrix`` (or any object with
    ``values``, ``index`` and ``columns``), plus ``device`` for the pdist
    (``None`` = the first CUDA card)."""
    ensure_headless_backend()
    import matplotlib.pyplot as plt
    from scipy.cluster.hierarchy import dendrogram

    found = _dendrogram_linkage(df, dendro_direct, distmetric, linkmethod, device)
    if found is None:
        return
    link, labels, n_leaves = found

    if wd_ratio <= 0:
        print("wd_ratio must be a positive number (>0). "
              "Use default wd_ratio instead: 0.5")
        wd_ratio = 0.5
    if plot_ht <= 0:
        print("plot_ht must be a positive number (>0). "
              "Use default plot_ht instead: 8")
        plot_ht = 8

    fx = round(n_leaves * wd_ratio)
    plt.figure(figsize=(fx, plot_ht))
    setup_fonts()
    dendrogram(link, labels=labels, distance_sort=True, leaf_rotation=90,
               leaf_font_size=leaf_font_size)
    save_figure(outputname, pformat, pdpi)
    plt.close("all")
