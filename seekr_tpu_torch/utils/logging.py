"""Structured logging and per-stage timing.

Port of ``seekr_tpu/utils/logging.py:23-66``.  ``SEEKR_TPU_LOG=debug|info|warning``
sets the verbosity (default warning, so command output stays as quiet as the
reference's).  The loggers are ``seekr_tpu_torch`` and ``seekr_tpu_torch.timing``.
"""

from __future__ import annotations

import contextlib
import logging
import os
import sys
import threading
import time

from seekr_tpu_torch.utils.profiler import span

_CONFIGURED = False
_CONFIGURE_LOCK = threading.Lock()
ROOT = "seekr_tpu_torch"
TIMING = f"{ROOT}.timing"


def get_logger(name: str = ROOT) -> logging.Logger:
    global _CONFIGURED
    if not _CONFIGURED:
        # under a lock: two first calls at once must not attach two handlers
        with _CONFIGURE_LOCK:
            if not _CONFIGURED:
                level = os.environ.get("SEEKR_TPU_LOG", "warning").upper()
                root = logging.getLogger(ROOT)
                if not logging.getLogger().handlers:
                    # a standalone process: our own handler.  Where the host
                    # application configured logging, propagation delivers each
                    # record once through its handlers instead.
                    handler = logging.StreamHandler()
                    handler.setFormatter(logging.Formatter(
                        "%(asctime)s %(name)s %(levelname)s %(message)s", "%H:%M:%S"))
                    root.addHandler(handler)
                    root.propagate = False
                root.setLevel(getattr(logging, level, logging.WARNING))
                _CONFIGURED = True
    return logging.getLogger(name)


@contextlib.contextmanager
def stage_timer(stage: str, items: int | None = None, unit: str = "items"):
    """A ``span`` named ``stage`` (``utils/profiler.py``) that also logs the
    wall time of the block (and the throughput when ``items`` is given) to
    ``seekr_tpu_torch.timing``, also when the block raises.

    Where that logger takes INFO records, the block's end waits for the current
    CUDA card, so the logged time holds the device work the block enqueued;
    otherwise nothing waits and nothing is timed."""
    log = get_logger(TIMING)
    timed = log.isEnabledFor(logging.INFO)
    t0 = time.perf_counter()
    try:
        with span(stage):
            yield
            if timed:
                _sync_card()
    finally:
        if timed:
            dt = time.perf_counter() - t0
            if items:
                log.info("%s: %.3fs (%.1f %s/s)", stage, dt, items / max(dt, 1e-9), unit)
            else:
                log.info("%s: %.3fs", stage, dt)


def _sync_card() -> None:
    """Wait for the current CUDA card, where this process has used one."""
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        torch.cuda.synchronize()
