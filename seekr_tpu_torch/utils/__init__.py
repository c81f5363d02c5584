"""Device resolution, the kernel build, logging and tracing, and state carried
across from seekr_tpu."""

from seekr_tpu_torch.utils.logging import get_logger, stage_timer
from seekr_tpu_torch.utils.profiler import span, trace_session

__all__ = ["get_logger", "stage_timer", "span", "trace_session"]
