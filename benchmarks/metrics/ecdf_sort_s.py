"""Seconds a find_pval call spends copying the null to float64, dropping its
NaNs and sorting it on the host (the program's ecdf.sort span), per call."""

from kbench import program_spans


def read(rec):
    return program_spans.seconds_per_call(rec, "find_pval", {"ecdf.sort"})
