"""The port's data tools (``data/``) and their commands against seekr_tpu's,
on the CPU: ``canonical_gencode``, ``filter_gencode``, ``gen_rand_rnas``
(the same seed gives the same bytes) and the ``Downloader``, whose network
calls are replaced by a patched ``urllib.request.urlopen``: nothing here
touches the network.
"""

import gzip
import importlib
import io
from collections import Counter

import numpy as np
import pytest

from seekr_tpu_torch import cli
from seekr_tpu_torch.data import Downloader, RandomMaker, canonical_gencode, gen_rand_rnas
from seekr_tpu_torch.data.filter_gencode import (filter_gencode,
                                                 get_transcript_id_with_ensembl_canonical,
                                                 get_transcript_id_with_isoform)

# the packages' __init__ export functions named as their modules
jax_canonical = importlib.import_module("seekr_tpu.data.canonical")
jax_filter = importlib.import_module("seekr_tpu.data.filter_gencode")
jax_rand = importlib.import_module("seekr_tpu.data.rand_rnas")
filter_mod = importlib.import_module("seekr_tpu_torch.data.filter_gencode")
gencode_mod = importlib.import_module("seekr_tpu_torch.data.gencode")

CANONICAL = ('gene_id "G1"; transcript_id "T1.1"; transcript_name "Ab-201"; '
             'tag "basic"; tag "Ensembl_canonical";')
PLAIN = 'gene_id "G2"; transcript_id "T2.1"; transcript_name "Xy-202"; tag "basic";'


def kmers(seq, k):
    return Counter(seq[i:i + k] for i in range(len(seq) - k + 1))


@pytest.fixture
def gencode(tmp_path, monkeypatch):
    """A GENCODE-style fasta of 40 records and a GTF of their transcript lines
    (plus exon lines, which the filter must ignore), made from a seed."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(0)
    records, lines = [], []
    for i in range(40):
        n = int(rng.integers(50, 400))
        seq = "".join(rng.choice(list("ACGT"), size=n)) if i % 7 else "ACGT" * 20
        number = int(rng.integers(1, 4)) + (200 if rng.random() < 0.3 else 0)
        tid, name = f"T{i}.1", f"G{i // 2}-{number:03d}"
        records.append(f">{tid}|G{i // 2}|-|-|{name}|G{i // 2}|{len(seq)}|\n{seq}\n")
        tag = 'tag "Ensembl_canonical";' if rng.random() < 0.4 else 'tag "basic";'
        lines.append(f'chr1\ts\ttranscript\t1\t{n}\t.\t+\t.\tgene_id "G"; '
                     f'transcript_id "{tid}"; transcript_name "{name}"; {tag}\n')
        lines.append(f'chr1\ts\texon\t1\t{n}\t.\t+\t.\ttranscript_id "{tid}"; '
                     'tag "Ensembl_canonical";\n')
    (tmp_path / "in.fa").write_text("".join(records))
    (tmp_path / "in.gtf").write_text("# header\n" + "".join(lines))
    return str(tmp_path / "in.fa"), str(tmp_path / "in.gtf"), tmp_path


def test_gtf_attribute_parsers():
    assert get_transcript_id_with_ensembl_canonical(CANONICAL) == "T1.1"
    assert get_transcript_id_with_ensembl_canonical(PLAIN) == ""
    assert get_transcript_id_with_isoform(CANONICAL, "201") == "T1.1"
    assert get_transcript_id_with_isoform(PLAIN, "[0-9]02") == "T2.1"
    assert get_transcript_id_with_isoform(CANONICAL, "202") == ""
    for fn in ("_parse_attributes", "get_transcript_id_with_ensembl_canonical"):
        assert getattr(filter_mod, fn)(CANONICAL) == getattr(jax_filter, fn)(CANONICAL)


@pytest.mark.parametrize("options", [
    dict(len_threshold=200), dict(canonical=True), dict(isoform="20[12]"),
    dict(rm_dup=True), dict(canonical=True, isoform="00[13]", len_threshold=100, rm_dup=True),
], ids=["length", "canonical", "isoform", "rmdup", "all"])
def test_filter_gencode_matches_seekr_tpu(gencode, options):
    fa, gtf, tmp = gencode
    got = filter_gencode(fa, gtf, outputname="t", **options)
    want = jax_filter.filter_gencode(fa, gtf, outputname="j", **options)
    assert got == want and len(got[0]) > 0
    assert (tmp / "t.fa").read_bytes() == (tmp / "j.fa").read_bytes()


def test_filter_gencode_direct_rules(gencode):
    fa, gtf, _ = gencode
    headers, seqs = filter_gencode(fa, gtf, len_threshold=150, canonical=True, outputname="o")
    canonical = {line.split('transcript_id "')[1].split('"')[0]
                 for line in open(gtf) if "\ttranscript\t" in line and "Ensembl_canonical" in line}
    from seekr_tpu_torch.io.fasta import Reader

    reader = Reader(fa)
    want = [h[1:] for h, s in zip(reader.get_headers(), reader.get_seqs())
            if h[1:].split("|")[0] in canonical and len(s) >= 150]
    assert headers == want
    # dedup keeps the first of the repeated 'ACGT' * 20 records
    _, dedup = filter_gencode(fa, rm_dup=True, outputname="d")
    assert len(dedup) == len(set(dedup)) == 40 - (len(range(0, 40, 7)) - 1)
    assert filter_gencode(fa, canonical=True) is None  # canonical needs the GTF


@pytest.mark.parametrize("zeros", [2, 1])
def test_canonical_gencode_matches_seekr_tpu(gencode, zeros):
    fa, _, tmp = gencode
    got = canonical_gencode(fa, str(tmp / "t.fa"), zeros=zeros)
    want = jax_canonical.canonical_gencode(fa, str(tmp / "j.fa"), zeros=zeros)
    assert got == want
    assert (tmp / "t.fa").read_bytes() == (tmp / "j.fa").read_bytes()
    suffix = "-" + "0" * zeros + "1"
    kept = [line.split("|")[4] for line in (tmp / "t.fa").read_text().splitlines()
            if line.startswith(">")]
    if zeros == 2:
        assert kept and all(name.endswith(suffix) for name in kept)
    else:  # no '-01' name among 3-digit numbers: nothing kept, and the advice
        assert kept == [] and got == 0


@pytest.mark.parametrize("k,mutations,group", [
    (1, 0, False), (2, 0, False), (3, 0, False), (2, 3, False), (2, 0, True)])
def test_rand_rnas_same_seed_same_bytes_as_seekr_tpu(gencode, k, mutations, group):
    fa, _, tmp = gencode
    gen_rand_rnas(fa, str(tmp / "t.fa"), k=k, mutations=mutations, seed=11, group=group)
    jax_rand.gen_rand_rnas(fa, str(tmp / "j.fa"), k=k, mutations=mutations, seed=11,
                           group=group)
    assert (tmp / "t.fa").read_bytes() == (tmp / "j.fa").read_bytes()


@pytest.mark.parametrize("k", [2, 3, 4])
def test_shuffle_keeps_the_kmer_multiset(k):
    rng = np.random.default_rng(k)
    maker = RandomMaker(k=k, seed=5)
    for _ in range(5):
        seq = "".join(rng.choice(list("ACGT"), size=300))
        out = maker.shuffle(seq)
        assert kmers(out, k) == kmers(seq, k) and out[:k - 1] == seq[:k - 1]
    assert RandomMaker(k=2, mutations=4, seed=1).shuffle("A" * 50).count("A") == 46


def test_gen_rand_rnas_command(gencode):
    fa, _, tmp = gencode
    cli.main(["gen_rand_rnas", fa, "t.fa", "-k", "2", "-s", "3", "--device", "cpu"])
    jax_rand.gen_rand_rnas(fa, str(tmp / "j.fa"), k=2, seed=3)
    assert (tmp / "t.fa").read_bytes() == (tmp / "j.fa").read_bytes()


def test_filter_and_canonical_commands(gencode):
    fa, gtf, tmp = gencode
    cli.main(["filter_gencode", fa, "-gtf", gtf, "-len", "100", "-can", "-rd", "-o", "t",
              "--device", "cpu"])
    jax_filter.filter_gencode(fa, gtf, 100, True, "0", True, "j")
    assert (tmp / "t.fa").read_bytes() == (tmp / "j.fa").read_bytes()
    cli.main(["canonical_gencode", fa, "c.fa", "-z", "2", "--device", "cpu"])
    assert (tmp / "c.fa").read_bytes().count(b">") == canonical_gencode(fa, str(tmp / "d.fa"))


# -- the downloader ------------------------------------------------------------

def test_build_url():
    d = Downloader()
    url, gtf, release = d.build_url("lncRNA", "human", False, "38")
    assert url == ("ftp://ftp.ebi.ac.uk/pub/databases/gencode/Gencode_human/release_38/"
                   "gencode.v38.lncRNA_transcripts.fa.gz")
    assert gtf is None and release == "38"
    url, gtf, _ = d.build_url("all", "mouse", True, "M25")
    assert url.endswith("release_M25/gencode.vM25.transcripts.fa.gz")
    assert gtf.endswith("gencode.vM25.chr_patch_hapl_scaff.annotation.gtf.gz")
    for args in (("bad", "human", False, "1"), ("pc", "fish", False, "1"),
                 ("pc", "mouse", False, "25")):
        with pytest.raises(AssertionError):
            d.build_url(*args)


def test_find_current_release_reads_the_page(monkeypatch):
    pages = []

    def fake_urlopen(url):
        pages.append(url)
        return io.BytesIO(b"<html>\n<head>\n<title>GENCODE - Human Release 46</title>\n"
                          b"</head>\n</html>\n")

    monkeypatch.setattr(gencode_mod.urllib.request, "urlopen", fake_urlopen)
    assert Downloader().find_current_release("human") == "46"
    assert pages == ["https://www.gencodegenes.org/human/"]
    url, _, release = Downloader().build_url("pc", "human", False, None)
    assert release == "46" and "gencode.v46.pc_transcripts.fa.gz" in url


def test_get_gencode_downloads_and_gunzips(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    payload = b">t1\nACGT\n"
    monkeypatch.setattr(gencode_mod.urllib.request, "urlopen",
                        lambda url: io.BytesIO(gzip.compress(payload)))
    Downloader().get_gencode("lncRNA", release="40", fasta_path="x.fa.gz")
    assert (tmp_path / "x.fa").read_bytes() == payload and not (tmp_path / "x.fa.gz").exists()
    with pytest.raises(AssertionError):
        Downloader().get_gencode("lncRNA", release="40", fasta_path="x.fa")


def test_gunzip_strips_the_suffix_only(tmp_path):
    path = tmp_path / "zebra.fa.gz"
    path.write_bytes(gzip.compress(b"hello"))
    Downloader().gunzip(str(path))
    assert (tmp_path / "zebra.fa").read_bytes() == b"hello" and not path.exists()


def test_url_error_advice(tmp_path, monkeypatch, capsys):
    import urllib.error

    def refuse(url):
        raise urllib.error.URLError("550 Failed to change directory")

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(gencode_mod.urllib.request, "urlopen", refuse)
    cli.main(["download_gencode", "lncRNA", "-r", "99", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "failed to download" in out and "valid `--release`" in out
