"""The port's host C++ library (``seekr_tpu_torch.native``) against seekr_tpu's
(``seekr_tpu.native``): the same sources built twice by g++, called on the same
seeded numpy inputs in one process.

Tolerance: none.  The sorts, the FDR scans, the triangle helpers, the encoder
and the CSV bytes are compared bit for bit, Leiden's membership exactly (same
edges, same seed); and the port's native paths against its own numpy paths
(``SEEKR_TPU_HOST_SORT=numpy``), bit for bit.
"""

import itertools
from pathlib import Path

import numpy as np
import pytest

from seekr_tpu import native as jax_native
from seekr_tpu_torch import native
from seekr_tpu_torch.stats import multitest
from seekr_tpu_torch.utils import adj

FIXTURES = Path(__file__).resolve().parent / "fixtures"


def keys_with_ties(rng, n):
    """float64 keys with many exact ties, both zeros, subnormals and extremes."""
    keys = np.round(rng.random(n), 2)
    if n >= 8:
        keys[:8] = [0.0, -0.0, 1e-310, -1e-310, 1.0, 1.0, np.finfo(float).max, 5e-324]
    return keys


@pytest.mark.parametrize("n", [0, 1, 257, 70_000])
def test_argsort_bitwise(n):
    keys = keys_with_ties(np.random.default_rng(n), n)
    got_order, got_vals = native.argsort_f64(keys)
    want_order, want_vals = jax_native.argsort_f64(keys)
    np.testing.assert_array_equal(got_order, want_order)
    assert got_vals.tobytes() == want_vals.tobytes()
    # a stable sort: numpy's order wherever -0.0 and +0.0 do not both occur
    pos = keys_with_ties(np.random.default_rng(n), n)
    pos[pos == 0] = 0.0
    np.testing.assert_array_equal(native.argsort_f64(pos)[0], np.argsort(pos, kind="stable"))


def test_scatter_by_order_bitwise():
    rng = np.random.default_rng(1)
    vals, flags = rng.random(5000), rng.random(5000) < 0.3
    order = rng.permutation(5000)
    got = native.scatter_by_order(vals, order, flags=flags)
    want = jax_native.scatter_by_order(vals, order, flags=flags)
    assert got[0].tobytes() == want[0].tobytes()
    np.testing.assert_array_equal(got[1], want[1])
    ref = np.empty_like(vals)
    ref[order] = vals
    assert got[0].tobytes() == ref.tobytes()
    with pytest.raises(ValueError):
        native.scatter_by_order(vals[:3], np.array([0, 1, 7]))


@pytest.mark.parametrize("by", [False, True])
def test_fdr_bitwise(by):
    rng = np.random.default_rng(2)
    p = np.round(rng.random(20_000) ** 3, 4)  # ties included
    h = multitest._harmonic_sum(len(p)) if by else 0.0
    got = native.fdr_sorted(np.sort(p), 0.05, h)
    want = jax_native.fdr_sorted(np.sort(p), 0.05, h)
    assert got[0].tobytes() == want[0].tobytes() and got[1] == want[1]
    got, want = native.fdr_adjust(p, 0.05, h), jax_native.fdr_adjust(p, 0.05, h)
    assert got[0].tobytes() == want[0].tobytes() and got[2] == want[2]
    np.testing.assert_array_equal(got[1], want[1])
    p[5] = np.nan
    with pytest.raises(ValueError):
        native.fdr_adjust(p, 0.05, h)


def test_sym_round5_and_triu_bitwise():
    rng = np.random.default_rng(3)
    a = rng.random((300, 300))
    sym = np.round((a + a.T) / 2, 6)
    sym[7, :] = sym[:, 7] = np.nan
    asym = sym.copy()
    asym[4, 250] += 1e-4
    for mat in (sym, asym):
        assert native.sym_round5(mat) == jax_native.sym_round5(mat)
    assert native.sym_round5(sym) and not native.sym_round5(asym)
    flat = native.triu_values_f64(a)
    assert flat.tobytes() == jax_native.triu_values_f64(a).tobytes()
    assert flat.tobytes() == a[np.triu_indices(300, 1)].tobytes()
    filled = native.triu_fill_f64(300, flat, fill=np.nan)
    assert filled.tobytes() == jax_native.triu_fill_f64(300, flat, fill=np.nan).tobytes()


def csv_matrix(rng, dtype):
    m = (rng.standard_normal((40, 23)) * 10.0 ** rng.integers(-12, 17, (40, 23))).astype(dtype)
    m[0, :4] = [np.nan, np.inf, -np.inf, -0.0]
    m[1, :3] = [0.0, 1e-45 if dtype == np.float32 else 5e-324, 1e16]
    return m


@pytest.mark.parametrize("dtype,mode", [(np.float32, 0), (np.float32, 1), (np.float64, None)])
def test_csv_writer_bytes_equal(tmp_path, dtype, mode):
    m = csv_matrix(np.random.default_rng(4), dtype)
    labels = [f'"l{i},x"' if i % 7 == 0 else f"l{i}" for i in range(40)]
    header = "," + ",".join(f"c{j}" for j in range(23)) + "\n"
    for lib, name in ((native, "t.csv"), (jax_native, "j.csv")):
        path = str(tmp_path / name)
        kwargs = dict(header_line=header, row_label_cells=labels)
        if dtype == np.float32:
            lib.write_csv_f32(path, m[:20], mode=mode, **{**kwargs,
                                                          "row_label_cells": labels[:20]})
            lib.write_csv_f32(path, m[20:], mode=mode, header_line=None,
                              row_label_cells=labels[20:], append=True)
        else:
            lib.write_csv_f64(path, m[:20], **{**kwargs, "row_label_cells": labels[:20]})
            lib.write_csv_f64(path, m[20:], header_line=None, row_label_cells=labels[20:],
                              append=True)
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()


def test_read_csv_f32_equal(tmp_path):
    m = np.random.default_rng(5).random((30, 9)).astype(np.float32)
    labels = ['"a,b"', "t1", "7"] + [f"t{i}" for i in range(3, 30)]
    path = str(tmp_path / "r.csv")
    native.write_csv_f32(path, m, header_line=",x,y,z,a,b,c,d,e,f\n", row_label_cells=labels)
    got, want = native.read_csv_f32(path), jax_native.read_csv_f32(path)
    assert got[0].tobytes() == want[0].tobytes() == m.tobytes()
    assert got[1:] == want[1:] and got[2] == labels
    # an empty cell is NaN; a short row or a word is refused
    (tmp_path / "e.csv").write_text(",x,y\na,1.0,\nb,,2\n")
    values = native.read_csv_f32(str(tmp_path / "e.csv"))[0]
    assert np.isnan(values[[0, 1], [1, 0]]).all() and values[1, 1] == 2
    for i, body in enumerate(("a,1.0\n", "a,1.0,x\n")):
        (tmp_path / f"bad{i}.csv").write_text(",x,y\n" + body)
        with pytest.raises(IOError):
            native.read_csv_f32(str(tmp_path / f"bad{i}.csv"))


@pytest.mark.parametrize("fasta", ["data/example.fa", "data/v22_pc_head.fa", "ldseq.fa"])
def test_native_fasta_equal(fasta):
    path = str(FIXTURES / fasta)
    with native.NativeFasta(path) as got, jax_native.NativeFasta(path) as want:
        assert got.headers() == want.headers() and got.seqs() == want.seqs()
        np.testing.assert_array_equal(got.lengths(), want.lengths())
        ids = list(range(len(got)))[::-1]
        for lpad in (4, 1024):
            np.testing.assert_array_equal(got.encode_batch(ids, lpad),
                                          want.encode_batch(ids, lpad))
    nf = native.NativeFasta(path)
    nf.close()
    with pytest.raises(ValueError, match="closed"):
        len(nf)


def planted_edges(rng, families=6, size=9):
    """Dense weighted edges inside families, sparse weak ones across."""
    src, dst, w = [], [], []
    for i, j in itertools.combinations(range(families * size), 2):
        same = i // size == j // size
        if same or rng.random() < 0.04:
            src.append(i)
            dst.append(j)
            w.append(rng.uniform(0.5, 1.0) if same else rng.uniform(0.05, 0.3))
    return np.array(src), np.array(dst), np.array(w), families * size


@pytest.mark.parametrize("algo", native.ALGORITHMS)
def test_leiden_membership_equal(algo):
    src, dst, w, n = planted_edges(np.random.default_rng(6))
    rs = 0.3 if algo == "CPMVertexPartition" else 1.0
    got = native.leiden(src, dst, w, n, algo=algo, resolution=rs, seed=11)
    want = jax_native.leiden(src, dst, w, n, algo=algo, resolution=rs, seed=11)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, native.leiden(src, dst, w, n, algo=algo, resolution=rs, seed=11))


def test_leiden_rejects_bad_input():
    with pytest.raises(ValueError):
        native.leiden([0, 1], [1], None, 3)
    with pytest.raises(ValueError):
        native.leiden([0], [1], None, 2, seed=-1)
    with pytest.raises(ValueError):
        native.leiden([0], [1], None, 2, algo="NoSuchPartition")


@pytest.mark.parametrize("method", ["fdr_bh", "fdr_by", "holm", "fdr_tsbky"])
def test_multipletests_native_equals_numpy(monkeypatch, method):
    rng = np.random.default_rng(7)
    p = np.round(rng.random((300, 300)) ** 2, 5)
    results = {}
    for mode in ("native", "numpy"):
        monkeypatch.setenv("SEEKR_TPU_HOST_SORT", mode)
        results[mode] = multitest.multipletests(p, method=method)
    for got, want in zip(results["native"][:2], results["numpy"][:2]):
        assert got.tobytes() == want.tobytes()
    # a NaN sends the fused pair to numpy, which spreads it as statsmodels does
    p[3, 3] = np.nan
    monkeypatch.setenv("SEEKR_TPU_HOST_SORT", "native")
    got = multitest.multipletests(p, method=method)[1]
    monkeypatch.setenv("SEEKR_TPU_HOST_SORT", "numpy")
    assert got.tobytes() == multitest.multipletests(p, method=method)[1].tobytes()


def test_triu_helpers_native_equal_numpy(monkeypatch):
    a = np.random.default_rng(8).random((2100, 2100))
    monkeypatch.delenv("SEEKR_TPU_HOST_SORT", raising=False)  # the size gate decides
    flat = adj.triu_values(a)
    filled = adj.triu_fill(2100, flat)
    monkeypatch.setenv("SEEKR_TPU_HOST_SORT", "numpy")
    assert flat.tobytes() == adj.triu_values(a).tobytes()
    assert filled.tobytes() == adj.triu_fill(2100, flat).tobytes()


def test_gate_follows_the_environment(monkeypatch):
    monkeypatch.delenv("SEEKR_TPU_HOST_SORT", raising=False)
    assert not native.host_stats_native_ok(10, 100) and native.host_stats_native_ok(100, 100)
    monkeypatch.setenv("SEEKR_TPU_HOST_SORT", "native")
    assert native.host_stats_native_ok(10, 100)
    monkeypatch.setenv("SEEKR_TPU_HOST_SORT", "numpy")
    assert not native.host_stats_native_ok(10 ** 9, 100)


BUILD_IN = """
import sys
from pathlib import Path
sys.path.insert(0, sys.argv[3])
from seekr_tpu_torch.native import build
build.BUILD_DIR, build.CXX = Path(sys.argv[1]), sys.argv[2]
print(build.build_native_lib())
"""


def test_concurrent_builds_compile_once(tmp_path):
    # six processes build into one empty directory at the same time (as the
    # workers of a parallel test run do): the fcntl lock lets one compile, and
    # every process gets the same library
    import subprocess
    import sys

    log = tmp_path / "calls.log"
    cxx = tmp_path / "g++"
    cxx.write_text(f'#!/bin/sh\necho "$@" >> {log}\nexec g++ "$@"\n')
    cxx.chmod(0o755)
    root = str(Path(__file__).resolve().parents[1])
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_IN, str(tmp_path / "b"), str(cxx),
                               root], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(6)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [err for _, err in outs]
    assert len({out.strip() for out, _ in outs}) == 1
    calls = log.read_text().splitlines()
    assert len(calls) == len(native.build.SOURCES) + 1  # one compile each, one link
    assert [p.name for p in (tmp_path / "b").iterdir() if p.suffix == ".so"] == [
        Path(outs[0][0].strip()).name]
