"""Share of the traced slice in which no kernel, copy or set ran on the card
(the union of the device intervals, so overlapping work counts once)."""

from kbench.arith import union_length


def read(rec):
    tr = rec["trace"]
    if tr is None or not tr["events"] or tr["window_s"] <= 0:
        return None
    busy = union_length([(s, e) for _, s, e in tr["events"]])
    return 100.0 * (1.0 - busy / tr["window_s"])
