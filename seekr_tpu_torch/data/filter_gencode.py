"""Filter a GENCODE fasta by length, canonical tag, isoform and duplicates.

Port of ``seekr_tpu/data/filter_gencode.py`` (behavioural parity with
seekr/filter_gencode.py:114-225):

  * header length field = ``header.split('|')[-2]`` (GENCODE format)
  * canonical: keep transcripts whose GTF line (feature 'transcript') carries
    a ``tag ... Ensembl_canonical`` attribute
  * isoform: keep transcripts whose 3-digit transcript_name suffix fully
    matches the (regex-capable) isoform string
  * >50 GTF ids unmatched to fasta headers -> advisory warning
  * rm_dup: exact-duplicate sequences removed, first occurrence kept
  * writes ``{outputname}.fa`` and returns (headers, seqs) with '>' stripped

seekr_tpu's two deliberate deviations from the reference are kept:
  * canonical+isoform combined: the surviving GTF lines are aligned by
    transcript_id (the reference zips the per-GTF-line list against the
    per-fasta-record mask, misaligned whenever the files differ);
  * the length field is parsed only when length filtering is asked for, so
    dedup-only runs work on non-GENCODE headers.
"""

from __future__ import annotations

import re

from seekr_tpu_torch.io.fasta import Reader


def _parse_attributes(field: str):
    """9th-column GTF attribute string -> list of (key, value) pairs."""
    pairs = []
    for kv in field.split(";"):
        kv = kv.strip()
        if not kv:
            continue
        try:
            key, value = kv.split(None, 1)
        except ValueError:
            continue
        pairs.append((key, value.strip(' "')))
    return pairs


def get_transcript_id_with_ensembl_canonical(field: str) -> str:
    """transcript_id if the attributes carry an Ensembl_canonical tag.

    Empty string otherwise (seekr/filter_gencode.py:57-79).
    """
    transcript_id = None
    canonical = False
    for key, value in _parse_attributes(field):
        if key == "transcript_id":
            transcript_id = value
        if key == "tag" and "Ensembl_canonical" in value:
            canonical = True
    return transcript_id if canonical else ""


def get_transcript_id_with_isoform(field: str, isoform: str) -> str:
    """transcript_id if the transcript_name's 3-digit suffix matches.

    ``isoform`` may be a regex (e.g. '[0-9]01'); full match required
    (seekr/filter_gencode.py:85-110).
    """
    transcript_id = None
    isoform_match = False
    for key, value in _parse_attributes(field):
        if key == "transcript_id":
            transcript_id = value
        if key == "transcript_name":
            iso = value.split("-")[-1]
            if iso.isdigit() and len(iso) == 3:
                isoform_match = bool(re.match(f"^{isoform}$", iso))
    return transcript_id if isoform_match else ""


def _warn_unmatched(gtf_ids, header_ids, what):
    if len(set(gtf_ids) - set(header_ids)) > 50:
        print(f"After {what} filtering on gtf, there are more than 50 "
              "transcript_ids in gtf file that cannot be matched to the "
              "input fasta headers.")
        print("Please make sure the provided gtf file and fasta file are "
              "from the same release and same species.")
        print("Please use gtf and fasta files directly from gencode, other "
              "formats are not tested.")


def filter_gencode(fasta_path, gtf_path=None, len_threshold=0,
                   canonical=False, isoform="0", rm_dup=False,
                   outputname="test"):
    reader = Reader(fasta_path)
    seqs = reader.get_seqs()
    headers = [h[1:] for h in reader.get_headers()]

    headers_tids = [h.split("|")[0] for h in headers]
    # the GENCODE length field (split('|')[-2]) is parsed only when length
    # filtering is requested — the reference parses it eagerly and crashes
    # on plain (non-GENCODE) headers even for a dedup-only run
    # (seekr/filter_gencode.py:122-125; documented deviation)

    if canonical or isoform != "0":
        if gtf_path is None:
            print("Please provide a gtf file path for filtering by "
                  "Ensemble_canonical tag and/or isoform number")
            return

        with open(gtf_path) as f:
            gtfs = [line.strip().split("\t") for line in f
                    if line and line[0] != "#"]
        gtfs = [line for line in gtfs if len(line) > 8 and line[2] == "transcript"]

        if canonical:
            tids_by_line = [get_transcript_id_with_ensembl_canonical(line[8])
                            for line in gtfs]
            tids_set = set(t for t in tids_by_line if t != "")
            presence = [tid in tids_set for tid in headers_tids]
            _warn_unmatched(tids_set, headers_tids, "Ensemble_canonical tag")
            headers = [h for h, p in zip(headers, presence) if p]
            seqs = [s for s, p in zip(seqs, presence) if p]
            headers_tids = [t for t, p in zip(headers_tids, presence) if p]
            # restrict the GTF lines to the canonical transcripts that
            # survived in the fasta, so the isoform stage below evaluates
            # the same set.  The reference instead zips the per-GTF-LINE
            # list against the per-FASTA-RECORD presence mask
            # (seekr/filter_gencode.py:171) — misaligned lists that keep or
            # drop the wrong GTF lines whenever the files do not match 1:1;
            # documented deviation implementing the intended filter.
            surviving = set(headers_tids)
            gtfs = [g for g, t in zip(gtfs, tids_by_line)
                    if t != "" and t in surviving]

        if isoform != "0":
            itids = [get_transcript_id_with_isoform(line[8], isoform)
                     for line in gtfs]
            itids = [t for t in itids if t != ""]
            itids_set = set(itids)
            ipresence = [tid in itids_set for tid in headers_tids]
            _warn_unmatched(itids_set, headers_tids, "isoform")
            headers = [h for h, p in zip(headers, ipresence) if p]
            seqs = [s for s, p in zip(seqs, ipresence) if p]

    if len_threshold > 0:
        headers_len = [int(h.split("|")[-2]) for h in headers]
        keep = [n >= len_threshold for n in headers_len]
        seqs = [s for s, p in zip(seqs, keep) if p]
        headers = [h for h, p in zip(headers, keep) if p]

    if rm_dup:
        seen = set()
        headers_uni, seqs_uni = [], []
        for seq, header in zip(seqs, headers):
            if seq not in seen:
                seen.add(seq)
                seqs_uni.append(seq)
                headers_uni.append(header)
        seqs, headers = seqs_uni, headers_uni

    with open(f"{outputname}.fa", "w") as f:
        for header, seq in zip(headers, seqs):
            f.write(f">{header}\n{seq}\n")

    return headers, seqs
