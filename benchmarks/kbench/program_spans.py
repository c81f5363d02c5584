"""The program's own spans inside the traced slice.

The program records a span (``seekr_tpu_torch.utils.profiler.span``: a name,
its id, its parent's id, its thread, and its start and end on
``time.perf_counter``) while a ``torch.profiler`` session runs on its thread,
as it does through the traced slice of a ``--trace 1`` run.  That is the clock
the slice's device events are placed on, so a span and the device intervals
under it compare directly.  A span never synchronizes: around device work it
is the host's time.  Where the record has no trace, or the program records no
spans, every function here gives None, and so does the reader that calls it.
"""

from __future__ import annotations

from kbench.arith import union_length


def in_slice(rec: dict):
    """The program's spans that began and ended inside the traced slice."""
    tr = rec.get("trace")
    if tr is None:
        return None
    try:
        from seekr_tpu_torch.utils.profiler import recorded_spans
    except ImportError:  # a program without spans
        return None
    return [s for s in recorded_spans() if tr["t0"] <= s["t0"] and s["t1"] <= tr["t1"]]


def calls(rec: dict, name: str):
    """``[(span, spans inside it)]`` for each span named ``name`` in the slice
    (inside: on its thread, between its start and its end), or None where the
    slice holds none."""
    spans = in_slice(rec)
    if not spans:
        return None
    out = [(c, [s for s in spans if s is not c and s["thread"] == c["thread"]
                and c["t0"] <= s["t0"] and s["t1"] <= c["t1"]])
           for c in spans if c["name"] == name]
    return out or None


def seconds_per_call(rec: dict, call: str, names):
    """Mean over the ``call`` spans of the time the spans named in ``names``
    cover inside each (nested ones count once)."""
    found = calls(rec, call)
    if found is None:
        return None
    return sum(union_length([(s["t0"], s["t1"]) for s in inner if s["name"] in names])
               for _, inner in found) / len(found)
