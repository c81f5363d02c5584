"""Header-pattern canonical filter (the legacy ``seekr_canonical_gencode``).

Port of ``seekr_tpu/data/canonical.py``.  Old GENCODE releases numbered each
gene's isoforms ``-001``, ``-002``, ... with ``-001`` the primary transcript, so
keeping headers whose transcript name ends in ``-001`` approximated one isoform
per gene.  Current releases need ``filter_gencode``'s GTF-driven
``Ensembl_canonical`` filter instead; this one needs no GTF.  The transcript
name is the 5th ``|``-field of a GENCODE header when present (e.g.
``DDX11L1-202``), else the whole header; ``zeros`` makes the suffix
``-0{zeros}1`` (the legacy ``-z/--zeros`` flag).
"""

from __future__ import annotations

from seekr_tpu_torch.io.fasta import Reader


def canonical_gencode(in_fasta: str, out_fasta: str, zeros: int = 2) -> int:
    """Write records whose transcript name ends in ``-0..01`` (``zeros``
    zeros); returns the number kept."""
    suffix = "-" + "0" * int(zeros) + "1"
    reader = Reader(in_fasta)
    headers = reader.get_headers()
    seqs = reader.get_seqs()
    kept = 0
    with open(out_fasta, "w") as fh:
        for header, seq in zip(headers, seqs):
            fields = header.lstrip(">").split("|")
            name = fields[4] if len(fields) > 4 and fields[4] else fields[0]
            if name.endswith(suffix):
                fh.write(f"{header}\n{seq}\n")
                kept += 1
    if kept == 0:
        print(f"No transcript names ended in '{suffix}'. Note that current "
              "GENCODE releases no longer use -001 numbering; use "
              "seekr_filter_gencode with a GTF for Ensembl_canonical "
              "filtering.")
    return kept
