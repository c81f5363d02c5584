"""The port's streamed correction (``stats/stream_adj.py``) against its in-memory
``adj_pval`` and against seekr_tpu's ``adj_pval_stream``, on the CPU.

The contract is bitwise: for every method but hommel, the streamed .npy holds
the in-memory path's float64 values (NaN fills included) and the CSV its bytes.
Inputs are made from a seed with numpy; sizes sit on both sides of the native
sort gate (``stats.multitest._NATIVE_SORT_MIN`` values), under
``SEEKR_TPU_HOST_SORT=numpy`` and the native library.
"""

import numpy as np
import pandas as pd
import pytest

from seekr_tpu.stats.stream_adj import adj_pval_stream as jax_adj_pval_stream
from seekr_tpu_torch import cli
from seekr_tpu_torch.io.fast_csv import LabeledMatrix, read_labeled_csv
from seekr_tpu_torch.stats import multitest
from seekr_tpu_torch.stats.adj_pval import adj_pval
from seekr_tpu_torch.stats.stream_adj import _sortable_bits, adj_pval_stream

METHODS = ["bonferroni", "sidak", "holm", "holm-sidak", "simes-hochberg",
           "fdr_bh", "fdr_by", "fdr_tsbh", "fdr_tsbky"]


def sym_pvals(rng, m, dtype=np.float32):
    v = rng.uniform(0, 1, (m, m)).astype(dtype)
    v = np.triu(v, 1)
    v = v + v.T
    np.fill_diagonal(v, 1.0)
    return v.astype(dtype)


def labeled(arr):
    return LabeledMatrix(arr, [str(i) for i in range(arr.shape[0])],
                         [str(j) for j in range(arr.shape[1])])


def assert_stream_matches(tmp_path, arr, method, name="", **kwargs):
    """Streamed == in-memory, bitwise (.npy) and byte for byte (CSV); returns
    the streamed matrix."""
    want = adj_pval(labeled(arr), method, 0.05, outputname=str(tmp_path / f"mem{name}"))
    src = tmp_path / f"p{name}.npy"
    np.save(src, arr)
    out_npy = tmp_path / f"adj{name}.npy"
    assert adj_pval_stream(str(src), method, 0.05, outputname=str(tmp_path / f"st{name}"),
                           out_npy=str(out_npy), **kwargs) is None
    got = np.load(out_npy)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got.view(np.uint64), want.values.view(np.uint64))
    assert (tmp_path / f"st{name}.csv").read_bytes() == \
        (tmp_path / f"mem{name}.csv").read_bytes()
    return got


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("shape", ["symmetric", "rectangular"])
def test_every_method_bitwise_the_in_memory_path(tmp_path, method, shape):
    rng = np.random.default_rng(0)
    arr = sym_pvals(rng, 23) if shape == "symmetric" else \
        rng.uniform(0, 1, (11, 29)).astype(np.float32)
    got = assert_stream_matches(tmp_path, arr, method)
    if shape == "symmetric":  # only the upper triangle is corrected
        assert np.isnan(got[np.tril_indices(23)]).all()
        assert not np.isnan(got[np.triu_indices(23, 1)]).any()


@pytest.mark.parametrize("method", METHODS)
def test_npy_bitwise_seekr_tpu_stream(tmp_path, method):
    # the same .npy input through both packages' streamed corrections
    rng = np.random.default_rng(1)
    for name, arr in (("sym", sym_pvals(rng, 19)),
                      ("rect", rng.uniform(0, 1, (9, 31)).astype(np.float32))):
        src = tmp_path / f"{name}.npy"
        np.save(src, arr)
        adj_pval_stream(str(src), method, out_npy=str(tmp_path / f"t_{name}.npy"))
        jax_adj_pval_stream(str(src), method, out_npy=str(tmp_path / f"j_{name}.npy"))
        np.testing.assert_array_equal(np.load(tmp_path / f"t_{name}.npy").view(np.uint64),
                                      np.load(tmp_path / f"j_{name}.npy").view(np.uint64))


@pytest.mark.parametrize("sort", ["numpy", "native"])
@pytest.mark.parametrize("method", ["fdr_bh", "fdr_by", "holm", "fdr_tsbky"])
def test_both_sides_of_the_native_gate(tmp_path, monkeypatch, sort, method):
    # 300 x 300 symmetric: 44,850 values, under the gate; 270 x 270 full: 72,900,
    # over it.  SEEKR_TPU_HOST_SORT forces one path of the in-memory side.
    assert 300 * 299 // 2 < multitest._NATIVE_SORT_MIN < 270 * 270
    monkeypatch.setenv("SEEKR_TPU_HOST_SORT", sort)
    rng = np.random.default_rng(2)
    assert_stream_matches(tmp_path, sym_pvals(rng, 300), method, name="small")
    arr = rng.uniform(0, 1, (270, 270)).astype(np.float32)
    assert_stream_matches(tmp_path, arr, method, name="large")


@pytest.mark.parametrize("method", ["fdr_bh", "holm", "fdr_tsbh", "bonferroni"])
def test_tie_masses_with_a_small_bucket_cap(tmp_path, method):
    # empirical p-values take N+1 values: a grid of 41 here, and runs of exact
    # 0.0 and 1.0; a cap of 50 pairs forces the all-equal and refined segments
    rng = np.random.default_rng(3)
    arr = (rng.integers(0, 41, size=(40, 60)) / 40).astype(np.float32)
    arr[:5] = 0.0
    arr[-3:] = 1.0
    assert_stream_matches(tmp_path, arr, method, max_bucket_pairs=50)
    sym = (np.triu(rng.integers(0, 11, size=(50, 50)), 1) / 10).astype(np.float32)
    sym = sym + sym.T
    assert_stream_matches(tmp_path, sym, method, name="sym", max_bucket_pairs=50,
                          chunk_cells=64)


@pytest.mark.parametrize("method", ["fdr_bh", "holm", "bonferroni", "fdr_tsbky"])
def test_nan_cells(tmp_path, method):
    rng = np.random.default_rng(4)
    arr = rng.uniform(0, 1, (7, 9)).astype(np.float32)
    arr[2, 4] = arr[5, 0] = np.nan
    assert_stream_matches(tmp_path, arr, method)
    sym = sym_pvals(rng, 12)
    sym[3, 7] = sym[7, 3] = np.nan
    assert_stream_matches(tmp_path, sym, method, name="sym")


def test_float64_input_and_small_chunks(tmp_path):
    rng = np.random.default_rng(5)
    arr = rng.choice([0.001, 0.01, 0.2, 0.2, 0.5, 1.0], size=(9, 13))
    assert_stream_matches(tmp_path, arr, "fdr_bh", chunk_cells=4)
    assert_stream_matches(tmp_path, sym_pvals(rng, 13, np.float64), "fdr_by", name="s",
                          chunk_cells=4)


def test_float32_out_and_unlink_input(tmp_path):
    rng = np.random.default_rng(6)
    arr = sym_pvals(rng, 15)
    src = tmp_path / "p.npy"
    np.save(src, arr)
    adj_pval_stream(str(src), "fdr_bh", out_npy=str(tmp_path / "o32.npy"),
                    out_dtype=np.float32, unlink_input=True)
    assert not src.exists()
    want = adj_pval(labeled(arr), "fdr_bh").values
    got = np.load(tmp_path / "o32.npy")
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want.astype(np.float32))


def test_scratch_dir_and_environment(tmp_path, monkeypatch):
    rng = np.random.default_rng(7)
    src = tmp_path / "p.npy"
    np.save(src, rng.uniform(0, 1, (6, 8)).astype(np.float32))
    scratch = tmp_path / "scratch"
    scratch.mkdir()
    seen = []
    adj_pval_stream(str(src), "holm", out_npy=str(tmp_path / "a.npy"),
                    scratch_dir=str(scratch), symmetric=False,
                    progress=lambda stage: seen.append(sorted(p.name for p in scratch.iterdir())))
    # the work went through one seekr_adj_* directory there, removed at the end
    assert seen and all(len(names) == 1 and names[0].startswith("seekr_adj_")
                        for names in seen)
    assert list(scratch.iterdir()) == []
    env_scratch = tmp_path / "env"
    env_scratch.mkdir()
    monkeypatch.setenv("SEEKR_TPU_SCRATCH", str(env_scratch))
    seen.clear()
    adj_pval_stream(str(src), "holm", out_npy=str(tmp_path / "b.npy"), symmetric=False,
                    progress=lambda stage: seen.append(len(list(env_scratch.iterdir()))))
    assert seen and all(n == 1 for n in seen) and list(env_scratch.iterdir()) == []
    assert (np.load(tmp_path / "a.npy") == np.load(tmp_path / "b.npy")).all()


def test_symmetric_override(tmp_path):
    # --symmetric no on a symmetric matrix corrects every cell, as
    # multipletests on the flattened matrix does; yes needs a square one
    rng = np.random.default_rng(8)
    arr = sym_pvals(rng, 10)
    src = tmp_path / "p.npy"
    np.save(src, arr)
    adj_pval_stream(str(src), "fdr_bh", out_npy=str(tmp_path / "full.npy"), symmetric=False)
    want = multitest.multipletests(arr.ravel(), method="fdr_bh")[1].reshape(arr.shape)
    np.testing.assert_array_equal(np.load(tmp_path / "full.npy").view(np.uint64),
                                  want.view(np.uint64))
    np.save(tmp_path / "r.npy", arr[:, :9])
    with pytest.raises(ValueError, match="square"):
        adj_pval_stream(str(tmp_path / "r.npy"), "fdr_bh", out_npy=str(tmp_path / "x.npy"),
                        symmetric=True)


def test_what_raises(tmp_path):
    src = tmp_path / "p.npy"
    np.save(src, np.full((3, 3), 0.5, np.float32))
    with pytest.raises(ValueError, match="hommel"):
        adj_pval_stream(str(src), "hommel", out_npy=str(tmp_path / "o.npy"))
    with pytest.raises(ValueError, match="not recognized"):
        adj_pval_stream(str(src), "nope", out_npy=str(tmp_path / "o.npy"))
    with pytest.raises(ValueError, match="artifacts only"):
        adj_pval_stream(str(src), "fdr_bh")
    np.save(src, np.full(3, 0.5, np.float32))
    with pytest.raises(ValueError, match="2-D"):
        adj_pval_stream(str(src), "fdr_bh", out_npy=str(tmp_path / "o.npy"))


def test_sortable_bits_order_floats():
    v = np.array([-np.inf, -1.5, -0.0, 0.0, 1e-30, 0.5, 1.0, np.inf, np.nan], np.float64)
    keys = _sortable_bits(v)
    assert (np.diff(keys.astype(np.float64)) >= 0).all()
    assert np.array_equal(np.argsort(_sortable_bits(v.astype(np.float32)), kind="stable"),
                          np.arange(len(v)))


def test_self_pvals_from_find_pval_are_detected_symmetric(tmp_path, monkeypatch):
    # the port's in-memory self p-values are mirrored, so both paths take the
    # upper triangle, and the streamed .npy of find_pval corrects the same way
    from seekr_tpu_torch.io.fasta import write_fasta
    from seekr_tpu_torch.stats.find_pval import find_pval

    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(9)
    seqs = ["".join(rng.choice(list("ACGT"), size=int(rng.integers(200, 600))))
            for _ in range(40)]
    write_fasta("s.fa", [f"s{i}" for i in range(40)], seqs)
    np.save("mean.npy", rng.uniform(5, 15, 64))
    np.save("std.npy", rng.uniform(2, 6, 64))
    background = rng.normal(0, 0.2, 3000)
    pv = find_pval("s.fa", "s.fa", "mean.npy", "std.npy", 3, background, npy_out="p.npy",
                   device="cpu")
    assert np.array_equal(pv.values, pv.values.T)
    find_pval("s.fa", "s.fa", "mean.npy", "std.npy", 3, background, stream=True,
              npy_out="ps.npy", device="cpu")
    for name in ("p.npy", "ps.npy"):
        out = tmp_path / f"adj_{name}"
        adj_pval_stream(name, "fdr_bh", out_npy=str(out))
        assert np.isnan(np.load(out)[np.tril_indices(40)]).all()
    np.testing.assert_array_equal(np.load(tmp_path / "adj_p.npy"),
                                  adj_pval(pv, "fdr_bh").values)


# -- the command --------------------------------------------------------------

def test_cli_binary_input_matches_seekr_tpu_cli(tmp_path, monkeypatch, capsys):
    from seekr_tpu import cli as jax_cli

    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(10)
    np.save("p.npy", sym_pvals(rng, 21))
    cli.main(["adj_pval", "p.npy", "fdr_by", "-bi", "-o", "t", "-bo", "t.npy",
              "--device", "cpu"])
    jax_cli.main(["adj_pval", "p.npy", "fdr_by", "-bi", "-o", "j", "-bo", "j.npy"])
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    np.testing.assert_array_equal(np.load("t.npy").view(np.uint64),
                                  np.load("j.npy").view(np.uint64))
    assert "is a symmetric matrix" in capsys.readouterr().out
    cli.main(["adj_pval", "p.npy", "fdr_by", "-bi", "--symmetric", "no", "-o", "full",
              "--device", "cpu"])
    full = read_labeled_csv("full.csv")
    assert full.shape == (21, 21) and not np.isnan(full.values).any()
    want = pd.read_csv("j.csv", index_col=0).to_numpy()
    np.testing.assert_array_equal(read_labeled_csv("t.csv").values, want)


@pytest.mark.parametrize("argv,message", [
    (["-bo", "x.npy"], "-bo requires -bi"),
    (["--symmetric", "yes"], "--symmetric requires -bi"),
])
def test_cli_binary_flags_need_binary_input(tmp_path, monkeypatch, capsys, argv, message):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as exc:
        cli.main(["adj_pval", "p.csv", "fdr_bh", *argv, "--device", "cpu"])
    assert exc.value.code == 2 and message in capsys.readouterr().err
