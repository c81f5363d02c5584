"""count_kmers_hiblocked's share of its roofline (bytes over 3.35 TB/s), per launch."""

from kbench.readers import roofline_pct


def read(rec):
    return roofline_pct(rec, "count_kmers_hiblocked", per="launch")
