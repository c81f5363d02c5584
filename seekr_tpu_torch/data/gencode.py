"""GENCODE fasta/GTF downloader.

Port of ``seekr_tpu/data/gencode.py`` (behavioural parity with the reference
Downloader, seekr/fasta.py:30-166): find the latest release on
gencodegenes.org, build the EBI FTP URLs, download the fasta (and optionally
the comprehensive GTF), gunzip in place, and print the same URLError advice.
Host code with the standard library only: the release page is read with
``urllib.request``, where seekr_tpu uses ``requests``.
"""

from __future__ import annotations

import gzip
import os
import shutil
import urllib.error
import urllib.request
from contextlib import closing


class Downloader:
    """Download fasta and gtf files from GENCODE."""

    def find_current_release(self, species: str) -> str:
        """Scrape GENCODE's site for the latest release name.

        species: 'human' or 'mouse' (seekr/fasta.py:37-52).
        """
        url = f"https://www.gencodegenes.org/{species}/"
        with closing(urllib.request.urlopen(url)) as page:
            html = page.read().decode("utf-8", errors="replace")
        title = next(line for line in html.splitlines() if "<title>" in line)
        return title.split("Release")[1].strip().strip("</title>")

    def build_url(self, biotype: str, species: str, gtf: bool, release):
        """EBI FTP URLs for a GENCODE transcript fasta (+ optional GTF).

        Same contract as seekr/fasta.py:54-97: returns
        ``(url, gtf_url_or_None, release)``; release is resolved to the
        latest when None.
        """
        assert biotype in ("all", "pc", "lncRNA"), \
            "'biotype' must be in ('all', 'pc', 'lncRNA')."
        assert species in ("human", "mouse"), \
            "'species' must be either 'human' or 'mouse'."
        prefix = {"all": "", "pc": "pc_", "lncRNA": "lncRNA_"}[biotype]
        if release is None:
            release = self.find_current_release(species)
        if species == "mouse":
            assert release[0] == "M", "Mouse releases must begin with 'M'."
        url_base = "ftp://ftp.ebi.ac.uk/pub/databases/gencode/Gencode_"
        url = (f"{url_base}{species}/release_{release}/"
               f"gencode.v{release}.{prefix}transcripts.fa.gz")
        gtf_url = None
        if gtf:
            gtf_url = (f"{url_base}{species}/release_{release}/"
                       f"gencode.v{release}.chr_patch_hapl_scaff."
                       "annotation.gtf.gz")
        return url, gtf_url, release

    def gunzip(self, gzip_path: str) -> None:
        """Unzip a gzipped file and remove the original (fasta.py:99-111).

        Deliberate deviation, as in seekr_tpu: the reference strips the
        ".gz" suffix with ``str.strip(".gz")``, which removes *characters*
        — a path like ``zebra.fa.gz`` would gunzip to ``ebra.fa``.  This
        implementation uses ``removesuffix`` so the output path is always
        the input path minus its ``.gz`` extension.
        """
        out_path = gzip_path.removesuffix(".gz")
        with gzip.open(gzip_path, "rb") as in_file:
            with open(out_path, "wb") as out_file:
                shutil.copyfileobj(in_file, out_file)
        os.remove(gzip_path)

    def get_gencode(self, biotype, species="human", gtf=False, release=None,
                    fasta_path=None, gtf_path=None, unzip=True):
        """Download .fa.gz (and optionally .gtf.gz) from GENCODE.

        Same parameters/defaults as seekr/fasta.py:113-166, including the
        'must end with .gz' path asserts and the URLError release hint.
        """
        url, gtf_url, release = self.build_url(biotype, species, gtf, release)

        if fasta_path is not None:
            assert fasta_path.endswith(".gz"), \
                "Even if unzipping, 'fasta_path' must end with '.gz'."
        if gtf_path is not None:
            assert gtf_path.endswith(".gz"), \
                "Even if unzipping, 'gtf_path' must end with '.gz'."

        try:
            with closing(urllib.request.urlopen(url)) as r:
                if fasta_path is None:
                    fasta_path = f"v{release}_{biotype}.fa.gz"
                with open(fasta_path, "wb") as out_file:
                    shutil.copyfileobj(r, out_file)
            if unzip:
                self.gunzip(fasta_path)

            if gtf:
                with closing(urllib.request.urlopen(gtf_url)) as r:
                    if gtf_path is None:
                        gtf_path = (f"v{release}_{biotype}."
                                    "chr_patch_hapl_scaff.annotation.gtf.gz")
                    with open(gtf_path, "wb") as out_file:
                        shutil.copyfileobj(r, out_file)
                if unzip:
                    self.gunzip(gtf_path)
        except urllib.error.URLError as url_error:
            print("The file failed to download because:\n", url_error)
            # the reference compares against a Python-2-era repr
            # ("...error_perm('550 ...',)>", fasta.py:164) that modern
            # urllib never produces — match the stable substring so the
            # hint actually fires on a bad release directory
            if "550 Failed to change directory" in str(url_error):
                print("Did you pass a valid `--release` value "
                      "(e.g. M14, 22)?")
