"""Seconds a find_pval call spends in the binary searches of every cell's r
into the sorted null on the host (the program's ecdf.search span), per call."""

from kbench import program_spans


def read(rec):
    return program_spans.seconds_per_call(rec, "find_pval", {"ecdf.search"})
