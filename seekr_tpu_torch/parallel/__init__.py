"""The device mesh in one process (``mesh``) and the pipeline, statistics,
long-sequence count, streamed Pearson and serving scorer over it (``dist``)."""

from seekr_tpu_torch.parallel.dist import (count_long_sequence, distributed_norm_stats,
                                           distributed_pipeline, init_distributed,
                                           make_sharded_scorer)
from seekr_tpu_torch.parallel.mesh import (data_sharding, make_mesh, replicated,
                                           row_col_sharding)

__all__ = [
    "make_mesh",
    "data_sharding",
    "row_col_sharding",
    "replicated",
    "distributed_pipeline",
    "distributed_norm_stats",
    "count_long_sequence",
    "init_distributed",
    "make_sharded_scorer",
]
