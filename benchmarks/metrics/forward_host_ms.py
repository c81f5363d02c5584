"""Host ms a forward spends in the program (the program's pipeline.forward
span), mean per forward.  The span holds no synchronize of its own, but
``ops/pearson.divide`` makes its divisor with ``torch.tensor(..., device=...)``,
a copy from pageable memory that waits for the stream: while that copy stays,
this reads the forward's device time, not the time to enqueue its work."""

from kbench import program_spans


def read(rec):
    found = program_spans.calls(rec, "pipeline.forward")
    if found is None:
        return None
    return 1e3 * sum(c["t1"] - c["t0"] for c, _ in found) / len(found)
