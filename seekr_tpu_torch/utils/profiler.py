"""Profiling hooks: ``torch.profiler`` traces and named regions.

Port of ``seekr_tpu/utils/profiler.py:26-74``.  ``SEEKR_TPU_TRACE=<dir>`` (read
at call time) or ``trace_session(dir)`` collects a trace of the host and, where
there is a card, of its kernels and copies, written as a Chrome trace
(``trace_<pid>_<ns>.json``) that ``chrome://tracing`` or Perfetto opens.
``profile_region(name)`` names a span inside it.
"""

from __future__ import annotations

import contextlib
import os
import time

_ACTIVE = False


def trace_dir():
    return os.environ.get("SEEKR_TPU_TRACE")


@contextlib.contextmanager
def trace_session(trace_dir_: str | None = None):
    """Trace the enclosed block into ``trace_dir_`` (default ``SEEKR_TPU_TRACE``);
    a no-op when neither names a directory or a trace is already running.
    Yields the path the trace will be written to, or None."""
    global _ACTIVE
    target = trace_dir_ or trace_dir()
    if not target or _ACTIVE:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, supported_activities

    os.makedirs(target, exist_ok=True)
    path = os.path.join(target, f"trace_{os.getpid()}_{time.time_ns()}.json")
    activities = [a for a in (ProfilerActivity.CPU, ProfilerActivity.CUDA)
                  if a in supported_activities()]
    _ACTIVE = True
    try:
        with profile(activities=activities) as prof:
            yield path
    finally:
        _ACTIVE = False
    prof.export_chrome_trace(path)


def profile_region(name: str):
    """A named span in the trace (``torch.profiler.record_function``); nearly
    free when no profiler runs."""
    import torch  # here, so that importing ``utils`` imports no torch

    return torch.profiler.record_function(name)
