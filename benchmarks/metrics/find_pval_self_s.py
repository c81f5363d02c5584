"""Mean seconds of a find_pval call that none of its direct child spans covers
(the program's spans: counters, FASTA parse, Pearson, ECDF sort and search)."""

from kbench import program_spans
from kbench.arith import union_length


def read(rec):
    found = program_spans.calls(rec, "find_pval")
    if found is None:
        return None
    own = [(c["t1"] - c["t0"])
           - union_length([(s["t0"], s["t1"]) for s in inner if s["parent"] == c["id"]])
           for c, inner in found]
    return sum(own) / len(own)
