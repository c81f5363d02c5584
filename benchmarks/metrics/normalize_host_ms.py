"""Host ms a forward spends in the normalize chain (the program's ``normalize``
span inside each ``pipeline.forward``), mean per forward.  The span holds no
synchronize: it is the time to enqueue the chain's launches, unless the card's
queue is full and the host waits for room.  None where the program records no
``normalize`` span."""

from kbench import program_spans
from kbench.arith import union_length


def read(rec):
    found = program_spans.calls(rec, "pipeline.forward")
    if found is None:
        return None
    per_forward = [[(s["t0"], s["t1"]) for s in inner if s["name"] == "normalize"]
                   for _, inner in found]
    if not any(per_forward):
        return None
    return 1e3 * sum(union_length(spans) for spans in per_forward) / len(found)
