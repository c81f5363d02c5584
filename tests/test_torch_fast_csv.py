"""The port's CSV/NPY writers and readers, its triangle helpers and collectors,
against seekr_tpu's on identical numpy input.

Tolerance: none.  Every writer is byte-equal to seekr_tpu's (which is
byte-equal to pandas / ``np.savetxt``), the reader equal to
``pd.read_csv(index_col=0)``, and the triangle helpers bitwise.
"""

import numpy as np
import pandas as pd
import pytest

from seekr_tpu.io import fast_csv as jax_csv
from seekr_tpu.io import stream as jax_stream
from seekr_tpu.models.counter import KmerCounter as JaxCounter
from seekr_tpu.utils import adj as jax_adj
from seekr_tpu_torch.io import fast_csv
from seekr_tpu_torch.io import stream
from seekr_tpu_torch.models.counter import KmerCounter
from seekr_tpu_torch.stats.find_dist import write_fit_results
from seekr_tpu_torch.utils import adj

LABELS = ["a,b", 'say "hi"', 5, "7", " x y", ">t1", "", "é"]


def read(path):
    with open(path, "rb") as fh:
        return fh.read()


def matrix(rng, rows, cols, dtype=np.float32):
    """Values over many magnitudes, with NaN, +-inf, -0.0 and 0."""
    m = rng.standard_normal((rows, cols)) * 10.0 ** rng.integers(-12, 14, (rows, cols))
    m = m.astype(dtype)
    m[0, 1] = np.nan
    m[1, :] = np.nan
    m[2, 0], m[2, 1], m[2, 2], m[2, 3] = np.inf, -np.inf, -0.0, 0.0
    return m


def fixed6_values(rng):
    """float32 values for '%1.6f': exact ties at the 7th decimal, both signs,
    subnormals, inf, NaN and values up to float32's largest."""
    ties = (rng.integers(0, 10 ** 6, 4000) * 15625 / 2.0 ** rng.integers(0, 20, 4000))
    spread = rng.standard_normal(4000) * 10.0 ** rng.integers(-9, 13, 4000)
    edge = [np.nan, np.inf, -np.inf, -0.0, 0.0, 1e-45, -1e-45, 3.4e38, -3.4e38,
            5e-7, -5e-7, 4.9999997e-07, 1.5e-6, 2.5e-6, 0.5, 1.0, 9.9999995e-7,
            4.5e12, 4.7e12, 123456.789, 4096.0, 1e13]
    vals = np.concatenate([ties, -ties[:500], spread, edge]).astype(np.float32)
    return np.resize(vals, (len(vals) // 41 + 1) * 41).reshape(-1, 41)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_labeled_csv_bytes_equal(tmp_path, dtype):
    m = matrix(np.random.default_rng(0), len(LABELS), 6, dtype)
    cols = ["c0", "c,1", 2, "3", "q\"r", "z"]
    fast_csv.write_labeled_csv(tmp_path / "t.csv", m, LABELS, cols)
    pd.DataFrame(m, index=LABELS, columns=cols).to_csv(tmp_path / "p.csv")
    assert read(tmp_path / "t.csv") == read(tmp_path / "p.csv")
    # seekr_tpu's native float32 writer quotes an empty label ('""') where
    # pandas, and the port, leave the cell empty; on any other label it is
    # byte-equal to both
    labels = [label or "-" for label in LABELS]
    jax_csv.write_labeled_csv(tmp_path / "j.csv", m, labels, cols)
    fast_csv.write_labeled_csv(tmp_path / "t.csv", m, labels, cols)
    assert read(tmp_path / "t.csv") == read(tmp_path / "j.csv")


def test_labeled_csv_large_block_bytes_equal(tmp_path):
    # several formatting blocks, rows of uneven width
    rng = np.random.default_rng(1)
    m = rng.random((300, 9000)).astype(np.float32) ** 3
    m[rng.random(m.shape) < 1e-3] = np.nan
    idx = [f"t{i}" for i in range(300)]
    cols = [f"t{j}" for j in range(9000)]
    jax_csv.write_labeled_csv(tmp_path / "j.csv", m, idx, cols)
    fast_csv.write_labeled_csv(tmp_path / "t.csv", m, idx, cols)
    assert read(tmp_path / "t.csv") == read(tmp_path / "j.csv")


def test_labeled_csv_shape_mismatch_raises(tmp_path):
    with pytest.raises(ValueError, match="Shape of passed values"):
        fast_csv.write_labeled_csv(tmp_path / "t.csv", np.zeros((2, 2)), ["a"], ["x", "y"])
    assert not (tmp_path / "t.csv").exists()


def test_raw_csv_bytes_equal(tmp_path):
    m = fixed6_values(np.random.default_rng(2))
    jax_csv.write_raw_csv(tmp_path / "j.csv", m)
    fast_csv.write_raw_csv(tmp_path / "t.csv", m)
    np.savetxt(tmp_path / "n.csv", m, delimiter=",", fmt="%1.6f")
    assert read(tmp_path / "t.csv") == read(tmp_path / "j.csv") == read(tmp_path / "n.csv")


@pytest.mark.parametrize("labeled,fmt,dtype", [
    (True, "%s", np.float32),
    (True, "%s", np.float64),
    (False, "%1.6f", np.float32),
    (False, "%.3e", np.float64),
], ids=["labeled-f32", "labeled-f64", "raw-f32", "other-fmt"])
def test_streamed_csv_bytes_equal(tmp_path, labeled, fmt, dtype):
    rng = np.random.default_rng(3)
    m = (fixed6_values(rng)[:, :7] if fmt == "%1.6f"
         else matrix(rng, 40, 7, dtype))
    idx = [f"r,{i}" if i % 3 == 0 else f"r{i}" for i in range(len(m))]
    cols = [f"c{j}" for j in range(m.shape[1])] if labeled else None
    kw = dict(columns=cols, row_labels=idx if labeled else None, fmt=fmt)
    with jax_stream.StreamingCsvWriter(str(tmp_path / "j.csv"), **kw) as jw, \
            stream.StreamingCsvWriter(str(tmp_path / "t.csv"), **kw) as tw:
        for start in (0, 1, 9, 30):
            block = m[start:{0: 1, 1: 9, 9: 30, 30: len(m)}[start]]
            jw.append(block)
            tw.append(block)
    assert read(tmp_path / "t.csv") == read(tmp_path / "j.csv")
    if labeled:
        got = fast_csv.read_labeled_csv(tmp_path / "t.csv")
        # the shortest repr of a float32 reads back as that float32
        np.testing.assert_array_equal(got.values.astype(dtype), m)


def test_streamed_csv_shortfall_discards(tmp_path):
    w = stream.StreamingCsvWriter(str(tmp_path / "t.csv"), columns=["a"],
                                  row_labels=["x", "y"], fmt="%s")
    w.append(np.ones((1, 1), np.float32))
    with pytest.raises(AssertionError, match="expected 2 rows, wrote 1"):
        w.close()
    assert list(tmp_path.iterdir()) == []
    w.close()  # idempotent after the discard
    with pytest.raises(ValueError, match="requires row_labels"):
        stream.StreamingCsvWriter(str(tmp_path / "u.csv"), columns=["a"])
    assert list(tmp_path.iterdir()) == []


def test_streamed_npy_bytes_equal_and_shortfall(tmp_path):
    m = matrix(np.random.default_rng(4), 10, 5)
    with jax_stream.StreamingNpyWriter(str(tmp_path / "j"), m.shape) as jw, \
            stream.StreamingNpyWriter(str(tmp_path / "t"), m.shape) as tw:
        for block in (m[:3], m[3:]):
            jw.append(block)
            tw.append(block)
    assert read(tmp_path / "t.npy") == read(tmp_path / "j.npy")
    np.testing.assert_array_equal(np.load(tmp_path / "t.npy"), m)

    w = stream.StreamingNpyWriter(str(tmp_path / "short.npy"), m.shape)
    w.append(m[:4])
    with pytest.raises(ValueError, match="too many rows"):
        w.append(m)
    with pytest.raises(AssertionError, match="expected 10 rows, wrote 4"):
        w.close()
    assert not (tmp_path / "short.npy").exists() and not (tmp_path / "short.npy.part").exists()


def test_read_labeled_csv_matches_pandas(tmp_path):
    m = matrix(np.random.default_rng(5), len(LABELS), 4)
    cols = ["A", "b,c", "7", "d"]
    fast_csv.write_labeled_csv(tmp_path / "t.csv", m, LABELS, cols)
    got = fast_csv.read_labeled_csv(tmp_path / "t.csv")
    want = pd.read_csv(tmp_path / "t.csv", index_col=0)
    np.testing.assert_array_equal(got.values, want.to_numpy())
    assert got.values.dtype == np.float64 and got.shape == want.shape
    assert got.columns == list(want.columns)
    assert len(got.index) == len(want.index)
    for a, b in zip(got.index, want.index):
        assert a == b or (a != a and b != b)
    got.to_csv(tmp_path / "again.csv")  # the labeled matrix writes itself back
    assert read(tmp_path / "again.csv") == read(tmp_path / "t.csv")


@pytest.mark.parametrize("labels,want", [
    (["1", "-2", "+3"], [1, -2, 3]),
    (["1.5", "", "2"], [1.5, np.nan, 2.0]),
    (["a", "", "1"], ["a", np.nan, "1"]),
    (["1_000", "2"], ["1_000", "2"]),
])
def test_index_inference_matches_pandas(tmp_path, labels, want):
    path = tmp_path / "t.csv"
    path.write_text(",x\n" + "".join(f"{label},{i}\n" for i, label in enumerate(labels)))
    got = fast_csv.read_labeled_csv(path).index
    pandas = list(pd.read_csv(path, index_col=0).index)
    for g, w, p in zip(got, want, pandas):
        assert (g == w == p) or (g != g and w != w and p != p)
        assert type(g) is type(w)


def test_fit_results_csv_bytes_equal(tmp_path):
    results = [("norm", np.float64(0.0171884487997208), (-0.0158, 0.1548144966363907)),
               ("pareto", 0.25, (1.5, -3.0e-7, 2.0)),
               ("one", np.float64(1e-5), (0.5,)),
               ("nan", float("nan"), (1.0, 2.0)),
               ("inf", np.float64(np.inf), ()),
               ("big", np.float64(1.2345678901234567e16), (1e20, 3.0))]
    cols = ["distribution_name", "D_statistics", "params"]
    for name, rows in (("full", results), ("empty", [])):
        write_fit_results(tmp_path / f"t_{name}.csv", rows)
        pd.DataFrame(rows, columns=cols).to_csv(tmp_path / f"p_{name}.csv", index=False)
        assert read(tmp_path / f"t_{name}.csv") == read(tmp_path / f"p_{name}.csv")


@pytest.mark.parametrize("m", [1, 2, 7, 40])
def test_triu_helpers_bitwise(m):
    rng = np.random.default_rng(m)
    mat = rng.standard_normal((m, m))
    flat = adj.triu_values(mat)
    assert np.array_equal(flat, jax_adj.triu_values(mat))
    assert np.array_equal(flat, mat[np.triu_indices(m, 1)])
    assert np.array_equal(adj.triu_fill(m, flat), jax_adj.triu_fill(m, flat), equal_nan=True)
    ints = np.arange(m * (m - 1) // 2)
    assert np.array_equal(adj.triu_fill(m, ints, 0), jax_adj.triu_fill(m, ints, 0))
    t = np.arange(m * (m - 1) // 2)
    for got, want in zip(adj.triu_index_to_ij(m, t), jax_adj.triu_index_to_ij(m, t)):
        assert np.array_equal(got, want)


def test_triu_collector_bitwise():
    m = 23
    sim = np.random.default_rng(6).random((m, m)).astype(np.float32)
    ours, theirs = stream.TriuCollector(m), jax_stream.TriuCollector(m)
    for start in range(0, m, 5):
        ours.append(sim[start:start + 5])
        theirs.append(sim[start:start + 5])
    got = ours.result()
    assert got.dtype == np.float32 and np.array_equal(got, theirs.result())
    collector = stream.ArrayCollector()
    collector.append(sim[:4])
    collector.append(sim[4:])
    assert np.array_equal(collector.result(), sim)
    short = stream.TriuCollector(m)
    short.append(sim[:3])
    with pytest.raises(AssertionError, match="expected 23 rows, saw 3"):
        short.result()


@pytest.mark.parametrize("label", [True, False], ids=["labeled", "raw"])
def test_counter_save_csv_bytes_equal(example_fa, tmp_path, label):
    # raw counts: the port's histogram is bitwise seekr_tpu's
    kw = dict(k=3, binary=False, mean=False, std=False, log2="Log2.none",
              label=label, silent=True)
    JaxCounter(example_fa, str(tmp_path / "j.csv"), **kw).make_count_file()
    KmerCounter(example_fa, str(tmp_path / "t.csv"), device="cpu", **kw).make_count_file()
    assert read(tmp_path / "t.csv") == read(tmp_path / "j.csv")


def test_read_all_nan_matrix(tmp_path):
    # a k too large for a small corpus with computed std: every cell is NaN
    m = np.full((3, 4), np.nan, dtype=np.float32)
    fast_csv.write_labeled_csv(tmp_path / "t.csv", m, [">a", ">b", ">c"], list("wxyz"))
    got = fast_csv.read_labeled_csv(tmp_path / "t.csv")
    assert got.shape == (3, 4) and np.isnan(got.values).all()
    assert got.index == [">a", ">b", ">c"]


# -- the C++ formatter and parser against the numpy/Python ones ----------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_native_writer_bytes_equal_python_writer(tmp_path, dtype):
    # the labeled writer goes through the C++ formatter for float32 and float64;
    # labeled_csv_bytes is the numpy formatter, pandas the reference of both
    m = matrix(np.random.default_rng(7), len(LABELS), 6, dtype)
    assert fast_csv.native_writes(m, [fast_csv._quote(label) for label in LABELS])
    cols = ["c0", "c,1", 2, "3", "q\"r", "z"]
    fast_csv.write_labeled_csv(tmp_path / "t.csv", m, LABELS, cols)
    assert read(tmp_path / "t.csv") == fast_csv.labeled_csv_bytes(m, LABELS, cols)
    for nan_label in (np.nan, ""):  # pandas writes both as an empty cell
        labels = [nan_label] + LABELS[1:]
        fast_csv.write_labeled_csv(tmp_path / "n.csv", m, labels, cols)
        pd.DataFrame(m, index=labels, columns=cols).to_csv(tmp_path / "p.csv")
        assert read(tmp_path / "n.csv") == read(tmp_path / "p.csv")


def test_native_raw_writer_bytes_equal_savetxt(tmp_path):
    m = fixed6_values(np.random.default_rng(8))
    assert fast_csv.native_writes(m)
    fast_csv.write_raw_csv(tmp_path / "t.csv", m)
    np.savetxt(tmp_path / "n.csv", m, delimiter=",", fmt="%1.6f")
    assert read(tmp_path / "t.csv") == read(tmp_path / "n.csv")


def test_native_reader_equals_python_reader(tmp_path):
    m = matrix(np.random.default_rng(9), len(LABELS), 5)
    fast_csv.write_labeled_csv(tmp_path / "t.csv", m, LABELS, list("vwxyz"))
    got = fast_csv.read_labeled_csv(tmp_path / "t.csv", dtype=np.float32)
    assert fast_csv._read_native(tmp_path / "t.csv") is not None
    want = fast_csv.read_labeled_csv(tmp_path / "t.csv")
    assert got.values.dtype == np.float32 and got.values.tobytes() == m.tobytes()
    # the float64 parse of a float32's shortest repr rounds back to that float32
    assert want.values.astype(np.float32).tobytes() == got.values.tobytes()
    assert got.columns == want.columns
    for a, b in zip(got.index, want.index):
        assert a == b or (a != a and b != b)
    # a file the C++ parser refuses is read here, as float32 all the same
    (tmp_path / "short.csv").write_text(",x,y\na,1.5\nb,2,3\n")
    assert fast_csv._read_native(tmp_path / "short.csv") is None
    with pytest.raises(ValueError):
        fast_csv.read_labeled_csv(tmp_path / "short.csv", dtype=np.float32)


FIFO_READER = """
import json, sys
import numpy as np
sys.path.insert(0, sys.argv[2])
from seekr_tpu_torch.io.fast_csv import read_labeled_csv
got = read_labeled_csv(sys.argv[1], dtype=np.float32)
print(json.dumps({"index": got.index, "columns": got.columns,
                  "values": got.values.tolist()}))
"""


def test_read_fifo_returns_the_writers_data(tmp_path):
    # the C++ reader opens a FIFO, finds no size and closes it, losing the
    # writer's one payload; the port reads anything but a regular file in
    # Python.  The reader runs in a subprocess with a timeout and the writer
    # never blocks, so the test cannot hang.
    import json
    import os
    import subprocess
    import sys
    import threading
    import time
    from pathlib import Path

    fifo = str(tmp_path / "p.csv")
    os.mkfifo(fifo)
    payload = b",x,y\na,1.5,2\nb,-0.25,3e-05\n"
    errors = []

    def writer():
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            try:  # non-blocking: ENXIO until a reader has the FIFO open
                fd = os.open(fifo, os.O_WRONLY | os.O_NONBLOCK)
            except OSError:
                time.sleep(0.01)
                continue
            try:
                os.write(fd, payload)
            finally:
                os.close(fd)
            return
        errors.append("no reader opened the FIFO")

    thread = threading.Thread(target=writer, daemon=True)
    thread.start()
    root = str(Path(__file__).resolve().parents[1])
    proc = subprocess.run([sys.executable, "-c", FIFO_READER, fifo, root],
                          capture_output=True, text=True, timeout=60)
    thread.join(timeout=70)
    assert not thread.is_alive() and not errors
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout)
    assert got["index"] == ["a", "b"] and got["columns"] == ["x", "y"]
    np.testing.assert_array_equal(np.float32(got["values"]),
                                  np.float32([[1.5, 2], [-0.25, 3e-05]]))
