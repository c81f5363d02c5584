"""Device resolution, the kernel build, logging and tracing, and state carried
across from seekr_tpu."""

from seekr_tpu_torch.utils.logging import get_logger, stage_timer
from seekr_tpu_torch.utils.profiler import profile_region, trace_session

__all__ = ["get_logger", "stage_timer", "profile_region", "trace_session"]
