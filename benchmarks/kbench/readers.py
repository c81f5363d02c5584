"""What the per-layer readers share: device time by kernel, the roofline share."""

from __future__ import annotations

import re

from kbench import registry


def kernel_seconds(rec: dict, pattern: str):
    """``(seconds, launches)`` of the traced device events whose name matches."""
    rx = re.compile(pattern)
    hits = [e - s for name, s, e in rec["trace"]["events"] if rx.search(name)]
    return sum(hits), len(hits)


def roofline_pct(rec: dict, kernel: str, per: str):
    """A kernel's share of its roofline, in %: the least time its work needs on
    the chip (operations over the TF32 peak or bytes over the memory rate,
    whichever is larger) over its traced time, per launch (``per="launch"``) or
    per traced unit of work (``per="unit"``).  None where the trace has none."""
    if rec["trace"] is None:
        return None
    mod = registry.roofline(kernel)
    seconds, launches = kernel_seconds(rec, mod.KERNEL)
    units = launches if per == "launch" else rec["units_traced"]
    if not launches or not units or seconds <= 0:
        return None
    flops, nbytes = mod.work(rec["inputs"])
    peaks = rec["peaks"]
    bound = max(flops / peaks["tf32_flops_per_s"], nbytes / peaks["hbm_bytes_per_s"])
    return 100.0 * bound / (seconds / units)


def window_spans(rec: dict, name: str):
    """Durations of the harness's ``name`` spans that began inside the window."""
    return [b - a for a, b in rec["spans"].get(name, []) if a >= rec["t_window"]]
