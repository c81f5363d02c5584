"""A ``torch.profiler`` slice of the window, reduced to device intervals.

The slice is started and stopped between units of work.  Its Chrome trace is
written under the temporary directory, read back for the kernels, copies and
sets on the card, and deleted.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
MARK = "kbench_slice_start"


def _sync() -> None:
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Slice:
    """One traced slice: ``events`` are ``(name, start_s, end_s)`` on the
    window's clock (``time.perf_counter``), ``window_s`` is the slice's length."""

    def __init__(self):
        self._prof = None
        self.t0 = self.t1 = None
        self.events = []

    @property
    def active(self) -> bool:
        return self._prof is not None

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    @staticmethod
    def warm() -> None:
        """Start and stop the profiler once at set-up: its first start (CUPTI's
        set-up, seconds on the card) must not fall inside the window.  Call it,
        and ``start``, from the main thread: CUPTI refuses another."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.ones(1, device="cuda" if torch.cuda.is_available() else "cpu").add_(1)
            _sync()

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        _sync()
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.t0 = time.perf_counter()
        with torch.profiler.record_function(MARK):  # ties the trace's clock to ours
            pass

    def stop(self) -> None:
        _sync()
        self.t1 = time.perf_counter()
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as fh:
                trace = json.load(fh)
        finally:
            os.unlink(path)
        self.events = device_events(trace, self.t0, self.t1)


def device_events(trace: dict, t0: float, t1: float):
    """Device events of a Chrome trace, placed on ``[t0, t1]``.

    The trace's clock has its own origin: the host event ``MARK``, recorded
    just after ``t0``, ties it to ours.  Events are clipped to the slice.
    """
    evs = trace.get("traceEvents", [])
    marks = [e["ts"] for e in evs if e.get("name") == MARK and "ts" in e]
    dev = [e for e in evs if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    if not dev:
        return []
    origin = min(marks) if marks else min(e["ts"] for e in dev)
    out = []
    for e in dev:
        s = t0 + (float(e["ts"]) - origin) * 1e-6
        end = s + float(e.get("dur", 0.0)) * 1e-6
        s, end = max(s, t0), min(end, t1)
        if end > s:
            out.append((e.get("name", "?"), s, end))
    return out
