"""FASTA ingestion.

Port of ``seekr_tpu/io/fasta.py``.  Semantics match the reference reader
(seekr/fasta_reader.py:41-63): lines are stripped, multi-line sequences joined,
sequences upper-cased, and file order preserved.  One documented deviation, as in
seekr_tpu: blank lines are skipped, where the reference's ``line[0]`` raises
IndexError.  A file whose bytes cannot make them differ is parsed by the host C++
library (``native.NativeFasta``); the Python path here is the semantics.
"""

from __future__ import annotations

from typing import Iterable, Iterator, List, Optional, Tuple


class Reader:
    """Read a FASTA file into headers + single-line upper-case sequences.

    Parameters
    ----------
    infasta : str (default=None)
        Path to the input fasta file.
    outfasta : str (default=None)
        Path used by :meth:`save` to write ``self.data`` back out.
    names : iterable of str (default=None)
        Names used by :meth:`supply_basic_header`.
    """

    def __init__(self, infasta: Optional[str] = None, outfasta: Optional[str] = None,
                 names: Optional[Iterable[str]] = None):
        self.infasta = infasta
        self.outfasta = outfasta
        self.names = names
        self.data: Optional[List[str]] = None

    def _read_data(self) -> None:
        """Set ``data`` to the stripped lines of the fasta file."""
        with open(self.infasta) as infasta:
            self.data = [line.strip() for line in infasta]

    def _upper_seq_per_line(self) -> None:
        """Collapse each record's sequence onto one upper-case line.

        A header line must be followed by at least one sequence line (headers
        back-to-back raise AssertionError), as in the reference.
        """
        new_data: List[str] = []
        seq = ""
        seen_header = False
        for i, line in enumerate(self.data):
            if not line:
                continue  # blank lines are tolerated anywhere
            if line[:1] == ">":
                if seq:
                    new_data.append(seq.upper())
                    seq = ""
                else:
                    # the FIRST header legitimately has no sequence yet
                    assert not seen_header, \
                        f"There may be a header without a sequence at line {i}."
                seen_header = True
                new_data.append(line)
            else:
                seq += line
        new_data.append(seq.upper())
        self.data = new_data

    def _native_lines(self) -> Optional[List[str]]:
        """The C++ parse, or None where it could differ from the Python path.

        The byte-level gate shared with ``encode_fasta``
        (``io.encode._native_parse_is_safe``) refuses lone-CR line breaks, any
        non-ASCII byte and leading sequence lines; the checks after the parse
        refuse a file with no record or an empty sequence (the reference's
        header-without-a-sequence assertion fires on the Python path) and any
        CR or untrimmed edge left in a header or a sequence.
        """
        from seekr_tpu_torch.io.encode import _native_parse_is_safe

        if not _native_parse_is_safe(self.infasta):
            return None
        from seekr_tpu_torch import native

        try:
            with native.NativeFasta(self.infasta) as nf:
                headers = nf.headers()
                seqs = nf.seqs()
        except OSError:
            return None
        if not headers or len(headers) != len(seqs) or any(not s for s in seqs):
            return None
        if any("\r" in h or h != h.strip() for h in headers) \
                or any("\r" in s or s != s.strip() for s in seqs):
            return None
        data: List[str] = []
        for header, seq in zip(headers, seqs):
            data.append(header)
            data.append(seq)
        return data

    def get_lines(self) -> List[str]:
        if self.data is None:  # parse once per Reader instance
            self.data = self._native_lines()
        if self.data is None:
            self._read_data()
            self._upper_seq_per_line()
        return self.data

    def get_seqs(self) -> List[str]:
        return self.get_lines()[1::2]

    def get_headers(self) -> List[str]:
        """Headers including the leading ``>``."""
        return self.get_lines()[::2]

    def get_data(self, tuples_only: bool = False):
        clean = self.get_lines()
        headers = clean[::2]
        seqs = clean[1::2]
        tuples: Iterator[Tuple[str, str]] = zip(headers, seqs)
        if tuples_only:
            return tuples
        return tuples, headers, seqs

    def supply_basic_header(self) -> List[str]:
        """Convert header lines to GENCODE-ish format with name and length."""
        new_fasta: List[str] = []
        if self.names is None:
            self.names = iter(self.get_headers())
        names = iter(self.names)
        for i, line in enumerate(self.data):
            if line[:1] == ">":
                name = next(names).strip(">")
                length = len(self.data[i + 1])
                new_fasta.append(f">||||{name}||{length}|")
            else:
                new_fasta.append(line)
        return new_fasta

    def save(self) -> None:
        """Write ``self.data`` to ``self.outfasta``, one line per entry."""
        with open(self.outfasta, "w") as outfasta:
            for line in self.data:
                outfasta.write(line + "\n")


def write_fasta(path: str, headers: Iterable[str], seqs: Iterable[str]) -> None:
    """Write (header, seq) pairs; headers given WITHOUT the leading '>'."""
    with open(path, "w") as fh:
        for header, seq in zip(headers, seqs):
            fh.write(f">{header}\n{seq}\n")
