"""Seconds a find_pval call spends parsing and encoding FASTA files on the host
(the program's fasta.read and fasta.encode spans), per call."""

from kbench import program_spans


def read(rec):
    return program_spans.seconds_per_call(rec, "find_pval", {"fasta.read", "fasta.encode"})
