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


# -- the native parse and encode (host C++ library) ----------------------------

UNSAFE = {  # files the byte gate sends to the Python reader, and why
    "lone_cr": b">a\nAC\rGT\n>b\nAAAA\n",
    "non_ascii": ">a\nACGT\n>b é\nTTTT\n".encode(),
    "leading_sequence": b"ACGT\n>a\nTTTT\n",
    "empty_record": b">a\n>b\nACGT\n",
}


def assert_encoded_equal(got, want):
    assert got.n_seqs == want.n_seqs
    np.testing.assert_array_equal(got.lengths, want.lengths)
    assert len(got.buckets) == len(want.buckets)
    for g, w in zip(got.buckets, want.buckets):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("include", [None, [0, 2, 4]])
@pytest.mark.parametrize("fasta", FASTAS)
def test_encode_fasta_matches(fasta, include):
    path = str(FIXTURES / fasta)
    assert encode._native_parse_is_safe(path)
    kwargs = dict(min_bucket_len=64, max_rows_per_bucket=4, include_ids=include)
    got = encode.encode_fasta(path, 3, **kwargs)
    assert_encoded_equal(got, jax_encode.encode_fasta(path, 3, **kwargs))
    if include is None:  # and bit for bit the Python encode of the parsed strings
        seqs = JaxReader(path).get_seqs()
        assert_encoded_equal(got, encode.encode_seqs(seqs, 3, min_bucket_len=64,
                                                     max_rows_per_bucket=4))


@pytest.mark.parametrize("name", sorted(UNSAFE))
def test_unsafe_files_take_the_python_path(name, tmp_path):
    fa = tmp_path / f"{name}.fa"
    fa.write_bytes(UNSAFE[name])
    assert encode._native_parse_is_safe(str(fa)) == (name == "empty_record")
    assert encode._native_parse_is_safe(str(fa)) \
        == jax_encode._native_parse_is_safe(str(fa))
    outcomes = []
    for reader in (Reader, JaxReader):
        try:
            outcomes.append((reader(str(fa)).get_headers(), reader(str(fa)).get_seqs()))
        except AssertionError as e:  # the header-without-a-sequence check
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]
    if name != "empty_record":
        assert_encoded_equal(encode.encode_fasta(str(fa), 2),
                             jax_encode.encode_fasta(str(fa), 2))


def test_gate_scan_and_reader_native_parse(tmp_path):
    fa = tmp_path / "messy.fa"
    fa.write_text("\n\n>h1|x \nacgT\nGGca\n\n>h2\n\ttttn \n")
    assert encode._native_parse_is_safe(str(fa))
    reader = Reader(str(fa))
    assert reader._native_lines() == [">h1|x", "ACGTGGCA", ">h2", "TTTN"]
    assert reader.get_lines() == JaxReader(str(fa)).get_lines()
    assert not encode._native_parse_is_safe(str(tmp_path / "missing.fa"))


def test_counter_native_path_is_its_python_path(tmp_path):
    from seekr_tpu_torch.models.counter import _LONG_SEQ_THRESHOLD, KmerCounter

    rng = np.random.default_rng(3)
    letters = np.array(list("AGTCN"))
    lens = [5, 300, 700, 90, _LONG_SEQ_THRESHOLD + 50, 1500, 2]
    write_fasta(str(tmp_path / "c.fa"), [f"s{i}" for i in range(len(lens))],
                ["".join(letters[rng.integers(0, 5, size=n)]) for n in lens])
    raw = dict(mean=False, std=False, log2="Log2.none", silent=True, device="cpu")
    native = KmerCounter(str(tmp_path / "c.fa"), k=4, **raw)
    assert native._encode_from_file() is not None
    python = KmerCounter(str(tmp_path / "c.fa"), k=4, **raw)
    python.seqs = list(python.seqs)  # no longer the parsed list: Python encode
    got, want = native.get_counts(), python.get_counts()
    assert got.tobytes() == want.tobytes()
