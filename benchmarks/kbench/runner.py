"""One run of one cell: set-up, the measured window, the check, the result line.

A driver (``kbench/drivers/<traffic driver>.py``) has three functions:

    setup(ctx) -> state       builds and warms everything, then calls
                              ``ctx.open_window()`` just before the first timed unit
    window(ctx, state)        measures for ``ctx.seconds``; sets ``ctx.e2e``,
                              ``ctx.attempted``, ``ctx.failed`` and the record
    check(ctx, state) -> {}   after the window, the peak memory read and the
                              program's state freed: each compared number

The runner reads ``memory_peak_bytes`` between ``window`` and ``check``, so the
plain reference, which runs in ``check``, never sets the peak.
"""

from __future__ import annotations

import math
import sys
import time
from collections import defaultdict
from contextlib import contextmanager, redirect_stdout

from kbench import arith, registry
from kbench.guard import forbidden_modules


class Context:
    def __init__(self, cell, seed: int, seconds: float, trace: bool, device, t_proc: float):
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.t_proc = t_proc
        self.t_window = None
        self.setup_s = None
        self.e2e = {}
        self.attempted = 0
        self.failed = 0
        self.spans = defaultdict(list)
        self.counters = {}
        self.inputs = {}
        self.units_traced = 0
        self.slice = None
        self._exit = []
        if self.trace:
            from kbench.trace import Slice

            self.slice = Slice()

    def at_exit(self, fn) -> None:
        """Run ``fn`` when the run ends, whatever happened."""
        self._exit.append(fn)

    def close(self) -> None:
        while self._exit:
            self._exit.pop()()

    def open_window(self) -> float:
        """Set-up ends here: the first timed unit follows."""
        self.t_window = time.perf_counter()
        self.setup_s = self.t_window - self.t_proc
        return self.t_window

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans[name].append((t0, time.perf_counter()))

    def trace_bounds(self):
        """``(start, length)`` of the traced slice: the last ``trace_seconds``
        of the window (the mix's), or all of it.  The slice ends ``length``
        after it really started (the profiler takes a while to start), so its
        stop and the reading of its trace, which hold the interpreter, fall at
        the window's close and stall no work inside it."""
        length = self.traffic.get("trace_seconds")
        if length is None or length >= self.seconds:
            return self.t_window, self.seconds
        return self.t_window + self.seconds - length, length

    def record(self) -> dict:
        rec = {"cell": self.cell.name, "config": self.config, "traffic": self.traffic,
               "spans": dict(self.spans), "counters": self.counters,
               "inputs": self.inputs, "units_traced": self.units_traced,
               "t_window": self.t_window,
               "peaks": registry.peaks(), "trace": None}
        if self.slice is not None and self.slice.t1 is not None:
            rec["trace"] = {"events": self.slice.events, "t0": self.slice.t0,
                            "t1": self.slice.t1, "window_s": self.slice.window_s}
        return rec


def _device_info(device, trace_rec) -> dict:
    import torch

    info = {"platform": "gpu" if device.type == "cuda" else "cpu",
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": 1,
            "memory_peak_bytes": (int(torch.cuda.max_memory_allocated(device))
                                  if device.type == "cuda" else 0)}
    if trace_rec is not None:
        busy = arith.union_length([(s, e) for _, s, e in trace_rec["events"]])
        info["busy_s"] = busy
        info["window_s"] = trace_rec["window_s"]
    return info


def breakdown(rec: dict) -> dict:
    """The ten device operations that took most time, and the ten longest idle
    gaps, each named by the harness span the host was in at its middle."""
    tr = rec["trace"]
    by_name = defaultdict(float)
    for name, s, e in tr["events"]:
        by_name[name] += e - s
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = arith.idle_gaps([(s, e) for _, s, e in tr["events"]], tr["t0"], tr["t1"])
    named = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = (s + e) / 2.0
        host = next((name for name, spans in rec["spans"].items()
                     for a, b in spans if a <= mid <= b), "outside the harness's spans")
        named.append([host, e - s])
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": named}


def judge(checks: dict, limits: dict):
    """``(all within limits, {name: {"value", "limit"}})``; a NaN or a number
    with no limit fails."""
    out, ok = {}, True
    for name, value in checks.items():
        limit = limits.get(name)
        passed = limit is not None and not math.isnan(value) and value <= limit
        ok = ok and passed
        out[name] = {"value": value, "limit": limit}
    missing = set(limits) - set(checks)
    for name in sorted(missing):  # a number the run could not read
        ok = False
        out[name] = {"value": None, "limit": limits[name]}
    return ok, out


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_proc: float) -> dict:
    """Run ``cell`` once and return its result line as a dict."""
    import torch

    drv = registry.driver(cell.traffic["driver"])
    ctx = Context(cell, seed, seconds, trace, device, t_proc)
    try:
        # the program's messages go to stderr: stdout ends with the result line
        with redirect_stdout(sys.stderr):
            if ctx.slice is not None:
                ctx.slice.warm()
            ctx.spans["setup.process"].append((t_proc, time.perf_counter()))
            state = drv.setup(ctx)
            drv.window(ctx, state)
            rec = ctx.record()
            device_info = _device_info(device, rec["trace"])
            checks = drv.check(ctx, state)
            del state
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    finally:
        ctx.close()
    passed, compared = judge(checks, cell.limits)
    print("setup steps: " + ", ".join(
        f"{name.split('.', 1)[1]} {b - a:.3f} s" for name, spans in ctx.spans.items()
        if name.startswith("setup.") for a, b in spans) + f"; setup_s {ctx.setup_s:.3f} s",
        file=sys.stderr, flush=True)

    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = registry.metric_reader(m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {"setup_s": {"value": ctx.setup_s, "unit": "s"}}
        for m in cell.end_to_end:
            if m["name"] != "setup_s":
                metrics[m["name"]] = {"value": ctx.e2e[m["name"]], "unit": m["unit"]}

    result = {"correct": bool(passed and ctx.failed == 0),
              "attempted": int(ctx.attempted), "failed": int(ctx.failed),
              "metrics": metrics, "device": device_info}
    if trace and rec["trace"] is not None and rec["trace"]["events"]:
        result["breakdown"] = breakdown(rec)
    result["checks"] = compared
    return result


def finish(result: dict) -> int:
    """Print the compared numbers (stderr) and the result line (stdout, last),
    unless something of JAX reached the process."""
    found = forbidden_modules()
    if found:
        print(f"kbench: the process holds {found}: no result", file=sys.stderr, flush=True)
        return 3
    import json

    print(f"check failed: {result['failed']} of {result['attempted']} (limit 0)",
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_plain(result)), flush=True)
    return 0


def _plain(obj):
    """JSON has no infinity or NaN: such a number is written as a string."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return str(obj)
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_plain(v) for v in obj]
    return obj
