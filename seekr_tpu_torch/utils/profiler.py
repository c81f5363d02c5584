"""Profiling hooks: ``torch.profiler`` traces and the program's spans.

Port of ``seekr_tpu/utils/profiler.py:26-74``.  ``SEEKR_TPU_TRACE=<dir>`` (read
at call time) or ``trace_session(dir)`` collects a trace of the host and, where
there is a card, of its kernels and copies, written as a Chrome trace
(``trace_<pid>_<ns>.json``) that ``chrome://tracing`` or Perfetto opens.

``span(name)`` marks a stage of the program.  Outside a profiler
session it is one probe and a shared no-op context.  While a ``torch.profiler``
session runs on the calling thread (this module's ``trace_session``, or any
other), each span enters ``torch.profiler.record_function(name)``, so it shows
in the Chrome trace beside the kernels it launched, and is kept in an
in-memory buffer (``recorded_spans``) with its start and end on
``time.perf_counter``, its id, its parent's id and its thread.  A span never synchronizes: around device work it is
the host's enqueue time, and the trace's device events give the device time.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import sys
import threading
import time

_ACTIVE = False

MAX_SPANS = 100_000  # the buffer's bound; past it spans are counted, not kept


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


class _Off:
    """The span outside a profiler session: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return None


_OFF = _Off()


class _Recorder:
    """The spans recorded in this process, and each thread's open spans."""

    def __init__(self):
        self.lock = threading.Lock()
        self.spans = []
        self.dropped = 0
        self.ids = itertools.count(1)
        self.local = threading.local()

    def open_spans(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def keep(self, record: dict) -> None:
        with self.lock:
            if len(self.spans) < MAX_SPANS:
                self.spans.append(record)
            else:
                self.dropped += 1


_RECORDER = _Recorder()


class _Span:
    """A span inside a profiler session."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        import torch

        self._fn = torch.profiler.record_function(self.name)
        self._fn.__enter__()
        stack = _RECORDER.open_spans()
        parent = stack[-1] if stack else None
        self.id = next(_RECORDER.ids)
        self.parent = parent.id if parent else None
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        stack = _RECORDER.open_spans()
        if stack and stack[-1] is self:
            stack.pop()
        _RECORDER.keep({"name": self.name, "t0": self.t0, "t1": t1, "id": self.id,
                        "parent": self.parent, "thread": threading.get_ident()})
        self._fn.__exit__(*exc)
        return False


def _first_probe() -> bool:
    """Whether a ``torch.profiler`` session runs on this thread; never before
    torch is imported (a span imports no torch).  Once it is, ``_probe`` is
    torch's own per-thread check."""
    global _probe
    torch = sys.modules.get("torch")
    if torch is None:
        return False
    _probe = torch.autograd._profiler_enabled
    return _probe()


_probe = _first_probe


def span(name: str):
    """A named stage of the program, as a context manager.  Recorded only
    while a profiler session runs on the calling thread."""
    if not _probe():
        return _OFF
    return _Span(name)


def recorded_spans() -> list:
    """The recorded spans, in the order they ended: dicts of ``name``, ``t0``
    and ``t1`` (``time.perf_counter``), ``id``, ``parent`` (None on an
    outermost span) and ``thread``."""
    with _RECORDER.lock:
        return list(_RECORDER.spans)


def dropped_spans() -> int:
    """Spans not kept since the buffer reached ``MAX_SPANS``."""
    return _RECORDER.dropped


def reset_spans() -> None:
    """Empty the buffer and its count of dropped spans."""
    with _RECORDER.lock:
        _RECORDER.spans.clear()
        _RECORDER.dropped = 0
