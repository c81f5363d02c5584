"""Mean seconds of an adj_pval call in the window (the harness's span)."""

from kbench.readers import window_spans


def read(rec):
    spans = window_spans(rec, "adj_pval")
    return sum(spans) / len(spans) if spans else None
