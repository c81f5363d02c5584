"""Statistics layer: background-distribution fitting, p-values, corrections.

Port of ``seekr_tpu/stats`` (seekr/find_dist.py, find_pval.py, adj_pval.py):

  * the O(m^2 * 4^k) background all-pairs Pearson runs on the device as the
    blocked GEMM (``ops.pearson``, ``io.stream``), the sampled pairs of a large
    background as a device gather-dot (``ops.pearson.pearson_pairs``);
  * the empirical p-values are a sorted ``searchsorted`` against the
    background sample (``ops.ecdf``), the fitted ones a vectorized scipy cdf
    (``stats.fast_cdf``), both on the host in float64;
  * the multiple-test corrections are numpy (``stats.multitest``): statsmodels
    is not a dependency.
"""

from seekr_tpu_torch.stats.adj_pval import adj_pval
from seekr_tpu_torch.stats.find_dist import find_dist
from seekr_tpu_torch.stats.find_pval import find_pval
from seekr_tpu_torch.stats.multitest import multipletests

__all__ = ["multipletests", "find_dist", "find_pval", "adj_pval"]
