"""The port's warm-resident service against seekr_tpu's, on the CPU.

The same inputs, made from numpy seeds at seekr_tpu's own serving test size
(K=3, 6 targets of 60-200 bases), go through ``seekr_tpu.serve.SeekrService``
and ``seekr_tpu_torch.serve.SeekrService(device="cpu")``.  Tolerances:

* sim, and the top-k values, against seekr_tpu: rtol 1e-5 / atol 1e-5, the
  tolerance the port's Pearson is held to (tests/test_torch_pearson.py);
* top-k indices: equal wherever neighbouring values differ by more than 1e-6;
  among exactly equal values the lower index comes first;
* fitted p-values: the port's equal 1 - cdf of its own sim (rtol 1e-6), and
  within 1e-4 of seekr_tpu's; empirical ones equal ``SortedBackground`` of the
  port's sim exactly, and seekr_tpu's away from background values within 1e-5;
* coalesced against serial: counts and shift are bitwise, the merged GEMM may
  retile, so rtol 1e-4 / atol 1e-6, as seekr_tpu holds its own;
* within a package, what must not move is bitwise: existing targets' scores
  across a within-quantum grow, a snapshot reloaded, the segmented normalize
  against ``normalize_counts`` per segment.

Every wait is bounded: threads are joined with a timeout and checked dead.
"""

import threading
import time

import numpy as np
import pytest
import torch

from seekr_tpu import serve as jax_serve
from seekr_tpu.ops.normalize import normalize_counts_segmented as jax_segmented
from seekr_tpu_torch import serve
from seekr_tpu_torch.ops.ecdf import SortedBackground
from seekr_tpu_torch.ops.normalize import normalize_counts, normalize_counts_segmented

K = 3
DIGIT2CHAR = np.array(list("AGTC"))
FITRES = [("norm", 0.01, (0.0, 0.25))]
MODES = ["Log2.pre", "Log2.post", "Log2.none"]
SIM_TOL = dict(rtol=1e-5, atol=1e-5)
COALESCE_TOL = dict(rtol=1e-4, atol=1e-6)
JOIN_S = 60


def seqs_of(rng, n, lo=60, hi=200):
    return ["".join(DIGIT2CHAR[rng.integers(0, 4, size=int(rng.integers(lo, hi)))])
            for _ in range(n)]


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_serve")
    rng = np.random.default_rng(0)
    np.save(tmp / "mean.npy", rng.uniform(0.5, 2.0, 4 ** K))
    np.save(tmp / "std.npy", rng.uniform(0.5, 2.0, 4 ** K))
    targets = seqs_of(rng, 6)
    (tmp / "targets.fa").write_text(
        "".join(f">t{i}\n{s}\n" for i, s in enumerate(targets)))
    return tmp, targets


def services(tmp, **kw):
    """(port, seekr_tpu) services built from the same artifacts."""
    args = (str(tmp / "mean.npy"), str(tmp / "std.npy"))
    kw.setdefault("targets", str(tmp / "targets.fa"))
    if kw["targets"] is None:
        kw.pop("targets")
    return (serve.SeekrService(*args, k=K, device="cpu", **kw),
            jax_serve.SeekrService(*args, k=K, **kw))


def port_mesh():
    from seekr_tpu_torch.parallel.mesh import make_mesh

    return make_mesh([torch.device("cpu")] * 8)


def jax_mesh():
    import jax

    from seekr_tpu.parallel.mesh import make_mesh

    return make_mesh(jax.devices()[:8])


def assert_topk_idx_equal(got_idx, want_sim, want_idx, tol=1e-6):
    """Indices must match wherever neighbouring values differ by more than
    ``tol``; nearer values may legally swap between two GEMMs."""
    got_idx, want_idx, want_sim = map(np.asarray, (got_idx, want_idx, want_sim))
    mask = np.ones(want_idx.shape, bool)
    if want_sim.shape[1] > 1:
        near = np.abs(np.diff(want_sim, axis=1)) <= tol
        mask[:, :-1] &= ~near
        mask[:, 1:] &= ~near
    np.testing.assert_array_equal(got_idx[mask], want_idx[mask])


def assert_exact_ties_ascend(vals, idx):
    """Among exactly equal top-k values the lower index comes first."""
    vals, idx = np.asarray(vals), np.asarray(idx)
    tied = vals[:, 1:] == vals[:, :-1]
    assert (idx[:, 1:] > idx[:, :-1])[tied].all()


def hold_lock_and_fire(svc, calls):
    """Queue every call while holding the device lock, then release it: one
    leader drains the burst.  Returns the results in call order."""
    results = [None] * len(calls)
    errors = []

    def run(i):
        try:
            results[i] = calls[i]()
        except Exception as err:  # noqa: BLE001 -- asserted below
            errors.append(err)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(calls))]
    svc._lock.acquire()
    try:
        for t in threads:
            t.start()
        t0 = time.monotonic()
        while len(svc._queue) < len(calls):
            assert time.monotonic() - t0 < 30, "requests never queued"
            time.sleep(0.01)
    finally:
        svc._lock.release()
    for t in threads:
        t.join(timeout=JOIN_S)
        assert not t.is_alive()
    assert not errors, errors
    return results


# -- the segmented normalize ---------------------------------------------------

def raw_and_segments(seed, m=40, n=4 ** K, n_seg=5, bad_col=False):
    rng = np.random.default_rng(seed)
    raw = (rng.poisson(6.0, size=(m, n)) * (1000.0 / rng.integers(100, 3000, size=m))[:, None]
           ).astype(np.float32)
    mean = rng.uniform(0.5, 8.0, n)
    std = rng.uniform(0.5, 2.0, n)
    if bad_col:
        # a zero std: counts of 0 give 0/0 = NaN, others +inf; the NaN rows
        # make their segment NaN, the inf ones leave it finite elsewhere
        mean[7], std[7] = 0.0, 0.0
        raw[:, 7] = 0.0
        raw[: m // 2, 7] = 5.0
    seg_ids = np.sort(rng.integers(0, n_seg, size=m)).astype(np.int32)
    return raw, seg_ids, mean, std


@pytest.mark.parametrize("bad_col", [False, True], ids=["finite", "nan-inf-column"])
@pytest.mark.parametrize("log2", MODES)
def test_segmented_normalize_matches_seekr_tpu(log2, bad_col):
    raw, seg_ids, mean, std = raw_and_segments(MODES.index(log2), bad_col=bad_col)
    got = normalize_counts_segmented(torch.from_numpy(raw), seg_ids, 8, log2_mode=log2,
                                     mean=mean, std=std).numpy()
    want = np.asarray(jax_segmented(raw, seg_ids, 8, log2_mode=log2, mean=mean, std=std))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, equal_nan=True)
    if bad_col:
        assert np.isnan(want).any() and np.isinf(want).any() == np.isinf(got).any()


@pytest.mark.parametrize("bad_col", [False, True], ids=["finite", "nan-inf-column"])
@pytest.mark.parametrize("log2", MODES)
def test_segmented_normalize_bitwise_per_segment(log2, bad_col):
    raw, seg_ids, mean, std = raw_and_segments(10 + MODES.index(log2), bad_col=bad_col)
    # scattered (not sorted) segment ids: the rows of a segment need not touch
    seg_ids = np.random.default_rng(3).permutation(seg_ids)
    got = normalize_counts_segmented(torch.from_numpy(raw), seg_ids, 8, log2_mode=log2,
                                     mean=mean, std=std).numpy()
    for s in np.unique(seg_ids):
        rows = seg_ids == s
        alone, _, _ = normalize_counts(torch.from_numpy(raw[rows]), log2_mode=log2,
                                       mean=mean, std=std)
        alone = alone.numpy()
        # every number bitwise; NaN in the same cells (its payload bits aside)
        nan = np.isnan(alone)
        np.testing.assert_array_equal(np.isnan(got[rows]), nan)
        np.testing.assert_array_equal(got[rows][~nan].view(np.int32), alone[~nan].view(np.int32))


def test_segmented_normalize_refuses_computed_stats():
    raw = torch.ones((4, 4 ** K))
    for kw in (dict(mean=True, std=np.ones(64)), dict(mean=np.ones(64), std=False)):
        with pytest.raises(ValueError, match="provided"):
            normalize_counts_segmented(raw, np.zeros(4, np.int32), 1, **kw)
    with pytest.raises(ValueError, match="log2 must be one of"):
        normalize_counts_segmented(raw, np.zeros(4, np.int32), 1, log2_mode="x",
                                   mean=np.ones(64), std=np.ones(64))


# -- the device top-k ------------------------------------------------------------

def test_topk_breaks_ties_toward_the_lower_index_as_lax_top_k():
    import jax

    rng = np.random.default_rng(4)
    sim = rng.integers(-3, 4, size=(16, 40)).astype(np.float32) / 4  # many exact ties
    vals, idx = serve._topk(torch.from_numpy(sim), 40, 8, False)
    want_vals, want_idx = jax.lax.top_k(sim, 8)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_vals))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    # masked columns are never selected, and ties among the rest still ascend
    vals, idx = serve._topk(torch.from_numpy(sim), 30, 16, True)
    assert (idx.numpy() < 30).all()
    want_vals, want_idx = jax.lax.top_k(np.where(np.arange(40) < 30, sim, -np.inf), 16)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))


def test_topk_matches_seekr_tpu(artifacts):
    tmp, _ = artifacts
    port, ref = services(tmp, fitres=FITRES)
    queries = seqs_of(np.random.default_rng(7), 3)  # pads to 4
    want = ("sim", "topk", "topk_pvals")
    got, exp = port.query(queries, want=want, topk=3), ref.query(queries, want=want, topk=3)
    assert got["topk_idx"].dtype == exp["topk_idx"].dtype == np.int32
    np.testing.assert_allclose(got["topk_sim"], exp["topk_sim"], **SIM_TOL)
    assert_topk_idx_equal(got["topk_idx"], exp["topk_sim"], exp["topk_idx"])
    np.testing.assert_allclose(got["topk_pvals"], exp["topk_pvals"], rtol=0, atol=1e-4)
    # the port's own top-k is a stable descending sort of its own sim, exactly
    order = np.argsort(-got["sim"], axis=1, kind="stable")[:, :3]
    np.testing.assert_array_equal(got["topk_idx"], order)
    np.testing.assert_array_equal(got["topk_sim"], np.take_along_axis(got["sim"], order, 1))


def test_self_similarity_duplicates_tie_to_the_lower_index(artifacts):
    tmp, _ = artifacts
    port, ref = services(tmp, targets=None)
    a, b, c = seqs_of(np.random.default_rng(8), 3)
    queries = [a, b, a, c, b]  # pads to 8 with copies of b: exact duplicates
    got = port.query(queries, want=("sim", "topk"), topk=10)
    exp = ref.query(queries, want=("sim", "topk"), topk=10)
    assert got["topk_idx"].shape == (5, 5) and (got["topk_idx"] < 5).all()
    np.testing.assert_allclose(got["sim"], exp["sim"], **SIM_TOL)
    np.testing.assert_allclose(got["topk_sim"], exp["topk_sim"], **SIM_TOL)
    assert_exact_ties_ascend(got["topk_sim"], got["topk_idx"])
    # each row's best matches are itself and its duplicate, lower index first
    assert got["topk_idx"][2, :2].tolist() == [0, 2] == exp["topk_idx"][2, :2].tolist()
    assert got["topk_idx"][4, :2].tolist() == [1, 4] == exp["topk_idx"][4, :2].tolist()


def test_topk_clamps_to_target_count(artifacts):
    tmp, targets = artifacts
    port, _ = services(tmp)
    queries = seqs_of(np.random.default_rng(9), 2)
    out = port.query(queries, want=("sim", "topk"), topk=999)
    assert out["topk_sim"].shape == (2, len(targets))
    np.testing.assert_array_equal(out["topk_sim"], -np.sort(-out["sim"], axis=1))


# -- sim and p-values --------------------------------------------------------------

@pytest.mark.parametrize("source", ["fasta", "list"])
def test_sim_matches_seekr_tpu(artifacts, source):
    tmp, targets = artifacts
    kw = {} if source == "fasta" else {"targets": targets}
    port, ref = services(tmp, **kw)
    queries = seqs_of(np.random.default_rng(1), 4)
    got, exp = port.query(queries), ref.query(queries)
    assert got["sim"].dtype == np.float32 and got["sim"].shape == (4, 6)
    np.testing.assert_allclose(got["sim"], exp["sim"], **SIM_TOL)
    assert (got["m"], got["n"]) == (exp["m"], exp["n"]) == (4, 6)
    assert port.target_names == ref.target_names
    assert port._targets_std.shape == (256, 4 ** K)  # the default quantum


def test_self_similarity_and_padding_match_seekr_tpu(artifacts):
    tmp, _ = artifacts
    port, ref = services(tmp, targets=None)
    queries = seqs_of(np.random.default_rng(2), 3)  # pads to 4
    got, exp = port.query(queries), ref.query(queries)
    assert got["sim"].shape == (3, 3) and (got["m"], got["n"]) == (3, 3)
    np.testing.assert_allclose(got["sim"], exp["sim"], **SIM_TOL)
    np.testing.assert_allclose(np.diag(got["sim"]), 1.0, rtol=1e-5)
    # the pad rows are invisible: the same rows alone at their own padding
    for i in range(3):
        np.testing.assert_allclose(port.query([queries[i], queries[i]])["sim"][0, 0], 1.0,
                                   rtol=1e-5)


def test_fitted_pvals(artifacts):
    tmp, _ = artifacts
    port, ref = services(tmp, fitres=FITRES)
    queries = seqs_of(np.random.default_rng(3), 2)
    got, exp = port.query(queries, want=("sim", "pvals")), ref.query(queries, want=("sim", "pvals"))
    from scipy import stats

    own = (1.0 - stats.norm(0.0, 0.25).cdf(got["sim"])).astype(np.float32)
    assert got["pvals"].dtype == np.float32
    np.testing.assert_allclose(got["pvals"], own, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got["pvals"], exp["pvals"], rtol=0, atol=1e-4)


def test_empirical_pvals(artifacts):
    tmp, _ = artifacts
    bkg = np.sort(np.random.default_rng(4).normal(0, 0.3, 5000))
    port, ref = services(tmp, fitres=bkg)
    queries = seqs_of(np.random.default_rng(5), 3)
    got, exp = port.query(queries, want=("sim", "pvals")), ref.query(queries, want=("sim", "pvals"))
    np.testing.assert_array_equal(got["pvals"],
                                  SortedBackground(bkg).pvals(got["sim"]).astype(np.float32))
    r = got["sim"].astype(np.float64)
    near = (np.searchsorted(bkg, r + 1e-5, side="right")
            > np.searchsorted(bkg, r - 1e-5, side="left"))
    np.testing.assert_array_equal(got["pvals"][~near], exp["pvals"][~near])


def test_query_errors_match_seekr_tpu(artifacts):
    tmp, _ = artifacts
    port, ref = services(tmp)
    for svc in (port, ref):
        with pytest.raises(ValueError, match="without fitres"):
            svc.query(["AGTCAGTC"], want=("pvals",))
        with pytest.raises(ValueError, match="unknown want"):
            svc.query(["AGTCAGTC"], want=("bogus",))
        with pytest.raises(ValueError, match="empty"):
            svc.query([])
    with pytest.raises(ValueError, match="4\\^k"):
        serve.SeekrService(str(tmp / "mean.npy"), str(tmp / "std.npy"), k=5, device="cpu")
    # a mesh needs targets, as in seekr_tpu
    with pytest.raises(ValueError, match="mesh serving requires targets"):
        serve.SeekrService(str(tmp / "mean.npy"), str(tmp / "std.npy"), k=K,
                           mesh=port_mesh(), device="cpu")
    with pytest.raises(ValueError, match="mesh serving requires targets"):
        jax_serve.SeekrService(str(tmp / "mean.npy"), str(tmp / "std.npy"), k=K,
                               mesh=jax_mesh())
    # follow() is a pod follower's (a mesh across processes), as in seekr_tpu
    for svc in (port, ref):
        with pytest.raises(ValueError, match=r"follow\(\) is for multi-host mesh serving"):
            svc.follow()
        svc.stop_followers()  # a no-op without followers


def test_latency_stats(artifacts):
    tmp, _ = artifacts
    port, _ = services(tmp)
    assert port.latency_stats() == {"count": 0}
    for seed in (30, 31, 32):
        port.query(seqs_of(np.random.default_rng(seed), 2), want=("topk",), topk=2)
    stats = port.latency_stats()
    assert stats["count"] == 3 and port.queries_served == 3 == port.device_batches
    assert 0 < stats["p50_ms"] <= stats["p95_ms"] <= stats["p99_ms"] <= stats["max_ms"]
    with pytest.raises(ValueError):
        port.query([])
    assert port.latency_stats()["count"] == 3  # rejected requests are not counted


# -- coalescing ----------------------------------------------------------------

def test_coalesced_matches_serial_and_seekr_tpu(artifacts):
    tmp, _ = artifacts
    port, ref = services(tmp, fitres=FITRES)
    serial = serve.SeekrService(str(tmp / "mean.npy"), str(tmp / "std.npy"), k=K,
                                targets=str(tmp / "targets.fa"), fitres=FITRES,
                                coalesce=False, device="cpu")
    rng = np.random.default_rng(12)
    reqs = [(seqs_of(rng, 2), ("sim",), 10), (seqs_of(rng, 3), ("topk",), 2),
            (seqs_of(rng, 1), ("topk", "topk_pvals"), 4), (seqs_of(rng, 4), ("sim", "pvals"), 10)]
    results = hold_lock_and_fire(
        port, [lambda r=r: port.query(r[0], want=r[1], topk=r[2]) for r in reqs])
    assert port.device_batches == 1 and port.queries_served == len(reqs)
    for (seqs, want, topk), got in zip(reqs, results):
        alone = serial.query(seqs, want=want, topk=topk)
        exp = ref.query(seqs, want=want, topk=topk)
        assert (got["m"], got["n"]) == (alone["m"], alone["n"]) == (exp["m"], exp["n"])
        for key in ("sim", "pvals", "topk_sim", "topk_pvals"):
            if key in alone:
                np.testing.assert_allclose(got[key], alone[key], **COALESCE_TOL, err_msg=key)
                np.testing.assert_allclose(got[key], exp[key], rtol=1e-4, atol=1e-4,
                                           err_msg=key)
        if "topk_idx" in alone:
            assert_topk_idx_equal(got["topk_idx"], alone["topk_sim"], alone["topk_idx"])
            assert_topk_idx_equal(got["topk_idx"], exp["topk_sim"], exp["topk_idx"])


def test_coalesce_row_cap_splits_batches(artifacts):
    tmp, _ = artifacts
    port, _ = services(tmp)
    port.max_coalesce_rows = 3
    rng = np.random.default_rng(14)
    reqs = [seqs_of(rng, 2) for _ in range(5)]  # 10 rows, a 3-row cap
    results = hold_lock_and_fire(
        port, [lambda s=s: port.query(s, want=("topk",), topk=2) for s in reqs])
    assert port.device_batches == 5 and port.queries_served == 5
    port.coalesce = False
    for seqs, got in zip(reqs, results):
        np.testing.assert_allclose(got["topk_sim"],
                                   port.query(seqs, want=("topk",), topk=2)["topk_sim"],
                                   **COALESCE_TOL)


def test_coalesced_failure_replays_each_request_alone(artifacts, monkeypatch):
    tmp, _ = artifacts
    port, _ = services(tmp)
    rng = np.random.default_rng(15)
    reqs = [seqs_of(rng, 1) for _ in range(3)]

    def broken(*args, **kwargs):
        raise RuntimeError("merged pass failed")

    import seekr_tpu_torch.ops.normalize as norm_mod

    monkeypatch.setattr(norm_mod, "normalize_counts_segmented", broken)
    results = hold_lock_and_fire(
        port, [lambda s=s: port.query(s, want=("sim",)) for s in reqs])
    assert port.device_batches == 3 and port.queries_served == 3
    port.coalesce = False
    for seqs, got in zip(reqs, results):
        np.testing.assert_array_equal(got["sim"], port.query(seqs)["sim"])


def test_warmup_sets_the_coalesce_cap_as_seekr_tpu(artifacts):
    tmp, _ = artifacts
    port, ref = services(tmp)
    for svc in (port, ref):
        assert svc.max_coalesce_rows == 512
        caps = []
        for max_batch in (2, 4, 2):
            svc.warmup(lengths=(64,), max_batch=max_batch, topk=2)
            caps.append(svc.max_coalesce_rows)
        assert caps == [2, 4, 4]


def test_single_bucket_policy(artifacts):
    tmp, _ = artifacts
    port, ref = services(tmp, targets=None)
    rng = np.random.default_rng(5)
    mixed = seqs_of(rng, 9, lo=60, hi=900)
    counter = port._seq_counter(mixed)
    assert counter.min_bucket_len == ref._seq_counter(mixed).min_bucket_len
    from seekr_tpu_torch.models.counter import KmerCounter

    bucketed = KmerCounter(None, k=K, mean=False, std=False, log2="Log2.none", silent=True,
                           device="cpu")
    bucketed.seqs = list(mixed)
    assert torch.equal(counter._raw_counts_device(), bucketed._raw_counts_device())
    bulk = seqs_of(rng, serve._SINGLE_BUCKET_MAX_ROWS + 1, lo=60, hi=70)
    assert port._seq_counter(bulk).min_bucket_len == 256  # bulk loads keep buckets
    assert port._pad_batch(["a", "b", "c"]) == ["a", "b", "c", "c"]


# -- the corpus: growth, budget, snapshots ------------------------------------

def test_add_targets_within_and_across_the_quantum(artifacts):
    tmp, _ = artifacts
    port, _ = services(tmp, grow_quantum=8)
    rng = np.random.default_rng(33)
    queries = seqs_of(rng, 2)
    before = port.query(queries)["sim"]
    resident = port._targets_std
    assert port.add_targets(seqs_of(rng, 2), names=["x0", "x1"]) == (8, 2)
    # an in-place row write: the same tensor, the same shape
    assert port._targets_std is resident and resident.shape == (8, 4 ** K)
    within = port.query(queries, want=("sim", "topk"), topk=8)
    np.testing.assert_array_equal(within["sim"][:, :6], before)  # bitwise
    assert_exact_ties_ascend(within["topk_sim"], within["topk_idx"])
    # across the quantum: the next multiple, auto-numbered names
    assert port.add_targets(seqs_of(rng, 3)) == (11, 3)
    assert port._targets_std.shape == (16, 4 ** K)
    assert port.target_names == [f"t{i}" for i in range(6)] + ["x0", "x1", "t8", "t9", "t10"]
    across = port.query(queries)["sim"]
    np.testing.assert_allclose(across[:, :8], within["sim"], **SIM_TOL)


def test_add_targets_matches_seekr_tpu(artifacts):
    tmp, _ = artifacts
    port, ref = services(tmp, grow_quantum=8)
    rng = np.random.default_rng(35)
    queries, extra, more = seqs_of(rng, 2), seqs_of(rng, 2), seqs_of(rng, 5)
    for svc in (port, ref):
        assert svc.add_targets(extra) == (8, 2)
        assert svc.add_targets(more) == (13, 5)
    assert port.target_names == ref.target_names
    got, exp = (svc.query(queries, want=("sim", "topk"), topk=13) for svc in (port, ref))
    np.testing.assert_allclose(got["sim"], exp["sim"], **SIM_TOL)
    assert_topk_idx_equal(got["topk_idx"], exp["topk_sim"], exp["topk_idx"])


def test_add_targets_validation(artifacts, tmp_path):
    tmp, _ = artifacts
    port, _ = services(tmp)
    with pytest.raises(ValueError, match="exactly one"):
        port.add_targets()
    with pytest.raises(ValueError, match="exactly one"):
        port.add_targets(["AGTC" * 20], fasta="x.fa")
    with pytest.raises(ValueError, match="names for"):
        port.add_targets(["AGTC" * 20], names=["a", "b"])
    with pytest.raises(ValueError, match="empty target batch"):
        port.add_targets([])
    selfsim, _ = services(tmp, targets=None)
    with pytest.raises(ValueError, match="without targets"):
        selfsim.add_targets(["AGTC" * 20])
    fa = tmp_path / "extra.fa"
    fa.write_text(">e0\n" + seqs_of(np.random.default_rng(36), 1)[0] + "\n")
    assert port.add_targets(fasta=str(fa)) == (7, 1) and port.target_names[-1] == "e0"


def test_budget_refusal_matches_seekr_tpu(artifacts):
    tmp, _ = artifacts
    # 6 targets, quantum 8: 8 x 64 x 4 = 2,048 bytes resident; the 9th row is refused
    port, ref = services(tmp, mem_budget_bytes=2048, grow_quantum=8)
    messages = []
    for svc in (port, ref):
        rng = np.random.default_rng(50)
        assert svc.add_targets(seqs_of(rng, 2))[0] == 8
        with pytest.raises(ValueError) as exc:
            svc.add_targets(seqs_of(rng, 1))
        messages.append(str(exc.value))
        assert svc._n_targets == 8
    # the same measured numbers; only seekr_tpu's advice to shard over a mesh differs
    assert messages[0].split("; raise")[0] == messages[1].split("; raise")[0]
    assert "16 rows" in messages[0] and "2,048-byte" in messages[0]
    assert port.query(seqs_of(np.random.default_rng(51), 2))["sim"].shape == (2, 8)


def test_corpus_budget_default_and_env(artifacts, monkeypatch):
    tmp, _ = artifacts
    args = (str(tmp / "mean.npy"), str(tmp / "std.npy"))
    monkeypatch.delenv("SEEKR_TPU_CORPUS_BUDGET", raising=False)
    assert serve.SeekrService(*args, k=K, device="cpu").mem_budget_bytes is None  # CPU: no cap
    monkeypatch.setenv("SEEKR_TPU_CORPUS_BUDGET", "0")
    assert serve.SeekrService(*args, k=K, device="cpu").mem_budget_bytes is None
    monkeypatch.setenv("SEEKR_TPU_CORPUS_BUDGET", "4096")
    assert serve.SeekrService(*args, k=K, device="cpu").mem_budget_bytes == 4096
    monkeypatch.setenv("SEEKR_TPU_CORPUS_BUDGET", "4G")
    with pytest.raises(ValueError, match="SEEKR_TPU_CORPUS_BUDGET"):
        serve.SeekrService(*args, k=K, device="cpu")


@pytest.mark.parametrize("writer", ["port", "seekr_tpu"])
def test_snapshot_loads_in_either_package(artifacts, tmp_path, writer):
    tmp, _ = artifacts
    port, ref = services(tmp)
    rng = np.random.default_rng(40)
    grow = seqs_of(rng, 2)
    port.add_targets(grow, names=["g0", "g1"])
    ref.add_targets(grow, names=["g0", "g1"])
    queries = seqs_of(rng, 3)
    snap = str(tmp_path / "corpus.npz")
    src = port if writer == "port" else ref
    assert src.save_corpus(snap) == snap
    with np.load(snap) as z:
        assert sorted(z.files) == ["format", "k", "log2", "mean", "names", "std", "tstd"]
        assert z["tstd"].shape == (8, 4 ** K)  # real rows only, no quantum pad
    loaded_port, loaded_ref = services(tmp, targets=snap)
    assert loaded_port.target_names == loaded_ref.target_names == src.target_names
    want = src.query(queries)["sim"]
    got_port, got_ref = loaded_port.query(queries)["sim"], loaded_ref.query(queries)["sim"]
    # the package that wrote it reloads it bitwise; the other within SIM_TOL
    np.testing.assert_array_equal(got_port if writer == "port" else got_ref, want)
    np.testing.assert_allclose(got_ref if writer == "port" else got_port, want, **SIM_TOL)


def test_save_corpus_validation_matches_seekr_tpu(artifacts, tmp_path):
    tmp, _ = artifacts
    port, _ = services(tmp)
    with pytest.raises(ValueError, match="end in .npz"):
        port.save_corpus(str(tmp_path / "corpus.weird"))
    selfsim, _ = services(tmp, targets=None)
    with pytest.raises(ValueError, match="no corpus to save"):
        selfsim.save_corpus(str(tmp_path / "c.npz"))
    snap = str(tmp_path / "corpus.npz")
    port.save_corpus(snap)
    rng = np.random.default_rng(41)
    np.save(tmp_path / "mean2.npy", rng.uniform(0.5, 2.0, 4 ** (K + 1)))
    np.save(tmp_path / "std2.npy", rng.uniform(0.5, 2.0, 4 ** (K + 1)))
    np.save(tmp_path / "mean3.npy", rng.uniform(0.5, 2.0, 4 ** K))
    bogus = tmp_path / "bogus.npz"
    np.savez(str(bogus), something=np.zeros(3))
    with np.load(snap) as z:
        parts = dict(z)
    parts["format"] = np.int64(2)
    np.savez(str(tmp_path / "future.npz"), **parts)
    cases = [(("mean2.npy", "std2.npy", K + 1, "Log2.post", snap), "k="),
             ((None, None, K, "Log2.none", snap), "log2"),
             (("mean3.npy", None, K, "Log2.post", snap), "DIFFERENT"),
             ((None, None, K, "Log2.post", str(bogus)), "not a seekr_tpu corpus"),
             ((None, None, K, "Log2.post", str(tmp_path / "future.npz")), "newer")]
    for (mean, std, k, log2, targets), match in cases:
        args = (str(tmp_path / mean) if mean else str(tmp / "mean.npy"),
                str(tmp_path / std) if std else str(tmp / "std.npy"))
        for cls, kw in ((serve.SeekrService, {"device": "cpu"}), (jax_serve.SeekrService, {})):
            with pytest.raises(ValueError, match=match):
                cls(*args, k=k, log2=log2, targets=targets, **kw)


def test_save_corpus_atomic_write(artifacts, tmp_path, monkeypatch):
    tmp, _ = artifacts
    port, _ = services(tmp)
    snap = tmp_path / "corpus.npz"

    def boom(*a, **k):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(np, "savez", boom)
    with pytest.raises(OSError):
        port.save_corpus(str(snap))
    assert not snap.exists() and not list(tmp_path.glob("*.npz.tmp"))


def test_growth_under_concurrent_load(artifacts):
    """Queries racing live growth: each answer is consistent with one corpus,
    and the original columns stay where they were in every response (within
    COALESCE_TOL: concurrent queries merge, and a merged GEMM may retile)."""
    tmp, _ = artifacts
    port, _ = services(tmp)
    rng = np.random.default_rng(44)
    queries = seqs_of(rng, 2)
    base = port.query(queries)["sim"]
    batches = [seqs_of(rng, 2) for _ in range(3)]
    outs, errs = [], []

    def client():
        try:
            for _ in range(4):
                outs.append(port.query(queries, want=("sim", "topk"), topk=20))
        except Exception as err:  # noqa: BLE001 -- asserted below
            errs.append(err)

    def grower():
        try:
            for batch in batches:
                port.add_targets(batch)
        except Exception as err:  # noqa: BLE001 -- asserted below
            errs.append(err)

    threads = [threading.Thread(target=client) for _ in range(3)]
    threads.append(threading.Thread(target=grower))
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
        assert not t.is_alive(), "serving deadlocked under growth"
    assert not errs, errs
    outs.append(port.query(queries, want=("sim", "topk"), topk=20))
    for out in outs:
        n = out["n"]
        assert n in {6, 8, 10, 12} and out["sim"].shape == (2, n)
        np.testing.assert_allclose(out["sim"][:, :6], base, **COALESCE_TOL)
        np.testing.assert_array_equal(out["topk_sim"], -np.sort(-out["sim"], axis=1))
    assert outs[-1]["n"] == 12


# -- the mesh ------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tied_targets():
    """13 targets (indivisible by the 8 shards) with exact duplicates whose rows
    land on different shards: t1 = t5 = t9 and t2 = t12."""
    targets = seqs_of(np.random.default_rng(60), 13)
    targets[5] = targets[9] = targets[1]
    targets[12] = targets[2]
    return targets


def test_mesh_service_matches_one_card_and_seekr_tpu(artifacts, tied_targets):
    tmp, _ = artifacts
    args = (str(tmp / "mean.npy"), str(tmp / "std.npy"))
    one = serve.SeekrService(*args, k=K, targets=tied_targets, device="cpu", fitres=FITRES)
    mesh = serve.SeekrService(*args, k=K, targets=tied_targets, mesh=port_mesh(),
                              grow_quantum=4, fitres=FITRES)
    ref = jax_serve.SeekrService(*args, k=K, targets=tied_targets, mesh=jax_mesh(),
                                 grow_quantum=4, fitres=FITRES)
    assert mesh.device == torch.device("cpu")  # the mesh's first device
    assert mesh._scorer.t_loc == 2 and mesh._resident_rows() == 16
    queries = seqs_of(np.random.default_rng(61), 3) + [tied_targets[1], tied_targets[2]]
    want = ("sim", "topk", "topk_pvals", "pvals")
    got, alone, exp = (svc.query(queries, want=want, topk=6) for svc in (mesh, one, ref))
    assert got["sim"].shape == (5, 13)
    np.testing.assert_allclose(got["sim"], alone["sim"], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got["topk_idx"], alone["topk_idx"])
    np.testing.assert_array_equal(got["topk_idx"], exp["topk_idx"])
    np.testing.assert_allclose(got["topk_sim"], exp["topk_sim"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["pvals"], alone["pvals"], rtol=0, atol=1e-5)
    # the planted ties cross shards and go to the lower global index
    assert got["topk_idx"][3, :3].tolist() == [1, 5, 9]
    assert got["topk_idx"][4, :2].tolist() == [2, 12]
    assert_exact_ties_ascend(got["topk_sim"], got["topk_idx"])
    only = mesh.query(queries, want=("topk",), topk=3)  # the topk-only executable
    np.testing.assert_array_equal(only["topk_idx"], got["topk_idx"][:, :3])


def test_mesh_service_coalesces_warms_grows_and_snapshots(artifacts, tied_targets, tmp_path):
    tmp, _ = artifacts
    args = (str(tmp / "mean.npy"), str(tmp / "std.npy"))
    svc = serve.SeekrService(*args, k=K, targets=tied_targets, mesh=port_mesh(),
                             grow_quantum=4, device="cpu")
    svc.warmup(lengths=(128,), max_batch=8, topk=4)
    rng = np.random.default_rng(62)
    reqs = [(seqs_of(rng, 2), ("sim",), 10), (seqs_of(rng, 3), ("topk",), 2),
            (seqs_of(rng, 1), ("sim", "topk"), 4)]
    serial = [svc.query(*r) for r in reqs]
    batches = svc.device_batches
    results = hold_lock_and_fire(
        svc, [lambda r=r: svc.query(r[0], want=r[1], topk=r[2]) for r in reqs])
    assert svc.device_batches == batches + 1
    for got, alone in zip(results, serial):
        for key in ("sim", "topk_sim"):
            if key in alone:
                np.testing.assert_allclose(got[key], alone[key], **COALESCE_TOL)
        if "topk_idx" in alone:
            assert_topk_idx_equal(got["topk_idx"], alone["topk_sim"], alone["topk_idx"])

    queries = seqs_of(rng, 2)
    before = svc.query(queries)["sim"]
    assert svc.add_targets(seqs_of(rng, 3)) == (16, 3) and svc._scorer.t_loc == 2
    within = svc.query(queries)["sim"]
    np.testing.assert_array_equal(within[:, :13], before)  # bitwise: no shape changed
    assert svc.add_targets(seqs_of(rng, 2)) == (18, 2) and svc._scorer.t_loc == 3
    across = svc.query(queries, want=("sim", "topk"), topk=18)
    np.testing.assert_allclose(across["sim"][:, :16], within, rtol=0, atol=1e-6)
    assert sorted(across["topk_idx"][0].tolist()) == list(range(18))

    snap = str(tmp_path / "mesh.npz")
    svc.save_corpus(snap)
    with np.load(snap) as z:
        assert z["tstd"].shape == (18, 4 ** K)  # real rows only
    again = serve.SeekrService(*args, k=K, targets=snap, mesh=port_mesh(), grow_quantum=4,
                               device="cpu")
    np.testing.assert_array_equal(again.query(queries)["sim"], across["sim"])
    single = serve.SeekrService(*args, k=K, targets=snap, device="cpu")
    np.testing.assert_allclose(single.query(queries)["sim"], across["sim"], rtol=0, atol=1e-6)


def test_mesh_budget_is_per_device(artifacts, tied_targets):
    tmp, _ = artifacts
    args = (str(tmp / "mean.npy"), str(tmp / "std.npy"))
    # 16 resident rows over 8 devices: 2 x 64 x 4 = 512 bytes each
    port = serve.SeekrService(*args, k=K, targets=tied_targets, mesh=port_mesh(),
                              grow_quantum=4, mem_budget_bytes=512)
    ref = jax_serve.SeekrService(*args, k=K, targets=tied_targets, mesh=jax_mesh(),
                                 grow_quantum=4, mem_budget_bytes=512)
    messages = []
    for svc in (port, ref):
        rng = np.random.default_rng(63)
        assert svc.add_targets(seqs_of(rng, 3))[0] == 16
        with pytest.raises(ValueError) as exc:
            svc.add_targets(seqs_of(rng, 1))
        messages.append(str(exc.value))
    assert messages[0] == messages[1] and "over 8 devices" in messages[0]


@pytest.mark.parametrize("env,want", [(None, 300.0), ("7.5", 7.5), ("0", None), ("-1", None),
                                      ("abc", "error")])
def test_pod_timeout_parsing_matches_seekr_tpu(monkeypatch, env, want):
    # SEEKR_TPU_POD_TIMEOUT: default 300 s, 0 or less turns the watchdog off, a
    # non-number raises seekr_tpu's error; PodScorer takes no collective to build
    from seekr_tpu.parallel.dist import PodScorer as JaxPodScorer
    from seekr_tpu_torch.parallel.dist import PodScorer, pod_timeout

    if env is None:
        monkeypatch.delenv("SEEKR_TPU_POD_TIMEOUT", raising=False)
    else:
        monkeypatch.setenv("SEEKR_TPU_POD_TIMEOUT", env)
    tstd = np.zeros((5, 4 ** K), np.float32)
    if want == "error":
        message = r"SEEKR_TPU_POD_TIMEOUT must be a number of seconds \(0 disables"
        with pytest.raises(ValueError, match=message):
            pod_timeout()
        with pytest.raises(ValueError, match=message):
            JaxPodScorer(jax_mesh(), tstd)
        return
    assert pod_timeout() == want == JaxPodScorer(jax_mesh(), tstd).timeout_s
    assert PodScorer(port_mesh(), tstd).timeout_s == want
    assert pod_timeout(2) == 2.0 == JaxPodScorer(jax_mesh(), tstd, timeout_s=2).timeout_s
