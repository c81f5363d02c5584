"""Visualization layer: heatmap, dendrogram, barplots, textplots, distribution.

Port of ``seekr_tpu/viz``: host-side matplotlib/seaborn drawing of matrices and
counts the card computed, one public function per reference command.  Importing
this package imports neither matplotlib nor seaborn: each plot imports them when
it draws, and its compute half runs without them.
"""

from seekr_tpu_torch.viz.kmer_count_barplot import kmer_count_barplot
from seekr_tpu_torch.viz.kmer_dendrogram import kmer_dendrogram
from seekr_tpu_torch.viz.kmer_heatmap import kmer_heatmap
from seekr_tpu_torch.viz.kmer_msd_barplot import kmer_msd_barplot
from seekr_tpu_torch.viz.textplot import kmer_comp_textplot, kmer_indi_textplot
from seekr_tpu_torch.viz.visualize_distro import visualize_distro

__all__ = [
    "kmer_heatmap",
    "kmer_dendrogram",
    "kmer_count_barplot",
    "kmer_msd_barplot",
    "kmer_comp_textplot",
    "kmer_indi_textplot",
    "visualize_distro",
]
