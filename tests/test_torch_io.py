"""The port's host io (FASTA reader, 2-bit encode, length buckets) against
seekr_tpu's, on the same files and strings.  Both are numpy and Python only, so
they agree exactly."""

from pathlib import Path

import numpy as np
import pytest

from seekr_tpu.io import encode as jax_encode
from seekr_tpu.io.fasta import Reader as JaxReader
from seekr_tpu_torch.io import encode
from seekr_tpu_torch.io.fasta import Reader, write_fasta

FIXTURES = Path(__file__).resolve().parent / "fixtures"
FASTAS = ["data/example.fa", "data/v22_pc_head.fa", "seqs1.fa", "ldseq.fa"]


@pytest.mark.parametrize("fasta", FASTAS)
def test_reader_matches(fasta, tmp_path):
    path = str(FIXTURES / fasta)
    got, want = Reader(path), JaxReader(path)
    assert got.get_seqs() == want.get_seqs()
    assert got.get_headers() == want.get_headers()
    assert list(got.get_data(tuples_only=True)) == list(want.get_data(tuples_only=True))
    assert got.supply_basic_header() == want.supply_basic_header()
    got.outfasta = str(tmp_path / "out.fa")
    got.save()
    assert Reader(got.outfasta).get_seqs() == want.get_seqs()


def test_reader_multiline_lowercase_and_blank_lines(tmp_path):
    fa = tmp_path / "x.fa"
    fa.write_text(">a desc\nacgt\nNNAC\n\n>b\n  GGTT  \n\n")
    reader = Reader(str(fa))
    assert reader.get_headers() == [">a desc", ">b"]
    assert reader.get_seqs() == ["ACGTNNAC", "GGTT"]
    bad = tmp_path / "bad.fa"
    bad.write_text(">a\n>b\nACGT\n")
    with pytest.raises(AssertionError, match="header without a sequence"):
        Reader(str(bad)).get_seqs()


def test_write_fasta_round_trip(tmp_path):
    path = str(tmp_path / "w.fa")
    write_fasta(path, ["s0", "s1"], ["ACGT", "TTNA"])
    assert Reader(path).get_headers() == [">s0", ">s1"]
    assert Reader(path).get_seqs() == ["ACGT", "TTNA"]


@pytest.mark.parametrize("k", [1, 3, 6])
def test_kmer_strings_and_bucket_lengths(k):
    assert encode.kmer_strings(k) == jax_encode.kmer_strings(k)
    assert encode.kmer_strings(2, "AC") == jax_encode.kmer_strings(2, "AC")
    for length in (0, 5, 255, 256, 257, 4096, 4097, 20000):
        assert encode.pick_bucket_length(length, k) == jax_encode.pick_bucket_length(length, k)
        assert (encode.pick_bucket_length(length, k, min_len=64)
                == jax_encode.pick_bucket_length(length, k, min_len=64))


def test_encode_seq_matches():
    for seq in ("ACGTNacgt-RY", "", "AGTC" * 10):
        np.testing.assert_array_equal(encode.encode_seq(seq), jax_encode.encode_seq(seq))
    np.testing.assert_array_equal(encode.encode_seq("ACGU", "ACGU"),
                                  jax_encode.encode_seq("ACGU", "ACGU"))


@pytest.mark.parametrize("max_rows", [None, 3])
def test_encode_seqs_buckets_match(max_rows):
    rng = np.random.default_rng(0)
    letters = np.array(list("AGTCNa"))
    seqs = ["".join(letters[rng.integers(0, 6, size=n)])
            for n in (0, 3, 100, 256, 257, 700, 1500, 300, 90, 2049, 10, 511)]
    got = encode.encode_seqs(seqs, 4, min_bucket_len=128, max_rows_per_bucket=max_rows)
    want = jax_encode.encode_seqs(seqs, 4, min_bucket_len=128, max_rows_per_bucket=max_rows)
    assert got.n_seqs == want.n_seqs and got.alphabet == want.alphabet
    np.testing.assert_array_equal(got.lengths, want.lengths)
    assert len(got.buckets) == len(want.buckets)
    for g, w in zip(got.buckets, want.buckets):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
