"""The port's device mesh (``seekr_tpu_torch.parallel``) against seekr_tpu's, on
the CPU.

seekr_tpu's mesh functions run on the 8 virtual CPU devices of
``tests/conftest.py``; the port's on a mesh of 8 CPU shards, and on (4, 2) where
a kmer axis is asked for.  Both get the same seeded numpy inputs.  Tolerances:

  * counts: each shard bitwise the port's single-device ``count_torch``;
    ``count_long_sequence`` bitwise seekr_tpu's;
  * normalized counts, mean, std: rtol 1e-4 / atol 1e-5, NaN where NaN,
    against seekr_tpu's mesh and the port's single-device ``normalize_counts``;
  * Pearson (pipeline, ``stream_pearson_sharded``): 1e-4 of seekr_tpu's mesh
    result;
  * ``ShardedScorer``: sim within 1e-6 of the single-device product, top-k
    indices equal (ties at the lower global index) and values within 1e-6 of
    seekr_tpu's scorer.
"""

import jax
import numpy as np
import pytest
import torch

from seekr_tpu.parallel import dist as jax_dist
from seekr_tpu.parallel.mesh import make_mesh as jax_make_mesh
from seekr_tpu_torch.io.stream import ArrayCollector
from seekr_tpu_torch.ops.count import count_torch
from seekr_tpu_torch.ops.normalize import normalize_counts
from seekr_tpu_torch.ops.pearson import pearson_device, standardize_rows
from seekr_tpu_torch.parallel import dist, mesh as mesh_mod
from seekr_tpu_torch.parallel.mesh import (build_mesh_from_flags, data_sharding, make_mesh,
                                           pad_to_shards, replicated, row_col_sharding,
                                           shard)

CPU = torch.device("cpu")
NORM_TOL = dict(rtol=1e-4, atol=1e-5, equal_nan=True)
R_TOL = dict(rtol=0, atol=1e-4, equal_nan=True)


def port_mesh(kmer_parallel=1):
    return make_mesh([CPU] * 8, kmer_parallel=kmer_parallel)


def jax_mesh(kmer_parallel=1):
    return jax_make_mesh(jax.devices()[:8], kmer_parallel=kmer_parallel)


def batch(rows, length, k, seed=0):
    rng = np.random.default_rng(seed)
    bases = rng.integers(0, 4, size=(rows, length), dtype=np.int8)
    bases[rng.random((rows, length)) < 0.02] = 4  # N bases
    lengths = rng.integers(k + 1, length + 1, size=rows, dtype=np.int32)
    for r in range(rows):
        bases[r, lengths[r]:] = 4
    return bases, lengths


def flat(x):
    x = np.asarray(x)
    return x.reshape(x.shape[0], -1) if x.ndim > 1 else x


# -- the mesh and placement ----------------------------------------------------

def test_mesh_shape_and_devices():
    mesh = port_mesh(kmer_parallel=2)
    assert mesh.shape == {"data": 4, "kmer": 2} and mesh.size == 8
    assert mesh.axis_names == ("data", "kmer") and mesh.devices.shape == (4, 2)
    assert mesh.first == CPU
    with pytest.raises(ValueError, match="divisible by kmer_parallel"):
        make_mesh([CPU] * 6, kmer_parallel=4)
    assert pad_to_shards(13, 8) == 16 and pad_to_shards(16, 8) == 16


def test_make_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        make_mesh()


def test_placement_helpers_match_seekr_tpus_shard_shapes():
    from seekr_tpu.parallel.mesh import data_sharding as jds
    from seekr_tpu.parallel.mesh import replicated as jrep
    from seekr_tpu.parallel.mesh import row_col_sharding as jrc

    pm, jm = port_mesh(2), jax_mesh(2)
    x = np.arange(8 * 16, dtype=np.float32).reshape(8, 16)
    v = np.arange(8, dtype=np.float32)
    cases = [(x, data_sharding(pm), jds(jm)), (x, row_col_sharding(pm), jrc(jm)),
             (v, replicated(pm), jrep(jm)), (v, data_sharding(pm, ndim=1), jds(jm, ndim=1))]
    for arr, ps, js in cases:
        got, want = shard(arr, ps), jax.device_put(arr, js)
        assert [tuple(s.data.shape) for s in got.shards] == \
            [s.data.shape for s in sorted(want.addressable_shards,
                                          key=lambda s: s.device.id)]
        np.testing.assert_array_equal(np.asarray(got), arr)
        np.testing.assert_array_equal(got.gather().numpy(), arr)
    with pytest.raises(ValueError, match="does not divide"):
        shard(np.zeros((6, 4)), data_sharding(pm))


@pytest.mark.parametrize("dp,kp,device,want", [
    (None, 1, "cpu", None), (1, 1, "cpu", None), (4, 1, "cpu", (4, 1)),
    (2, 2, "cpu", (2, 2)), (None, 2, "cpu", (1, 2)),
])
def test_build_mesh_from_flags(dp, kp, device, want):
    mesh = build_mesh_from_flags(dp, kp, device=device)
    if want is None:
        assert mesh is None
    else:
        assert mesh.devices.shape == want and all(d == CPU for d in mesh.devices.flat)


def test_build_mesh_from_flags_refusals(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match=r"requested 4 devices \(data_parallel=4 x "
                                         r"kmer_parallel=1\), have 0"):
        build_mesh_from_flags(4)
    # a process needs its index and a rendezvous: without RANK, or without a
    # coordinator and MASTER_ADDR, the bootstrap raises before joining anything
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(ValueError, match="RANK is not set"):
        dist.init_distributed("host0:8476", 2)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        build_mesh_from_flags(2, num_processes=2, process_id=0, device="cpu")
    assert dist.process_index() == 0 and dist.process_count() == 1
    dist.init_distributed()
    dist.init_distributed(num_processes=1)


def test_a_bare_coordinator_is_ignored():
    # as in seekr_tpu (parallel/mesh.py:61-89): only num_processes > 1 bootstraps
    mesh = build_mesh_from_flags(2, coordinator="host0:8476", device="cpu")
    assert mesh.devices.shape == (2, 1) and not mesh.spans_processes
    assert build_mesh_from_flags(None, coordinator="host0:8476", device="cpu") is None


def test_a_multi_host_mesh_must_use_every_device(monkeypatch):
    # four processes of one card each (the exchange of device names stubbed)
    from seekr_tpu_torch.parallel import comm

    monkeypatch.setattr(comm, "process_count", lambda: 4)
    monkeypatch.setattr(comm, "gather_objects", lambda names: [names] * 4)
    monkeypatch.setattr(mesh_mod, "_visible_cards", lambda: [torch.device("cuda", 0)])
    with pytest.raises(ValueError, match="multi-host runs must use all 4 devices: set "
                                         "data_parallel x kmer_parallel == 4"):
        build_mesh_from_flags(2)
    with pytest.raises(ValueError, match=r"requested 8 devices .* have 4"):
        build_mesh_from_flags(4, 2)
    mesh = build_mesh_from_flags(2, 2)
    assert mesh.owners.tolist() == [[0, 1], [2, 3]] and mesh.spans_processes
    assert mesh.local_positions == [(0, 0)] and mesh.first == torch.device("cuda", 0)
    # CPU shards split evenly over the processes
    with pytest.raises(ValueError, match="6 CPU shards do not divide over 4 processes"):
        build_mesh_from_flags(6, device="cpu")
    mesh = build_mesh_from_flags(8, device="cpu")
    assert mesh.owners.ravel().tolist() == [0, 0, 1, 1, 2, 2, 3, 3]


@pytest.mark.parametrize("identities,want", [
    ([["cpu"], ["cpu"]], "gloo"),                       # CPU processes
    ([["GPU-a"], ["GPU-a"]], "gloo"),                   # two processes on one card
    ([["GPU-a"], ["GPU-b"]], "nccl"),                   # a card each
    ([["GPU-a", "GPU-b"], ["GPU-c", "GPU-d"]], "nccl"),  # two cards each
    ([["GPU-a", "GPU-b"], ["GPU-b", "GPU-c"]], "gloo"),  # one card shared
    ([["GPU-a", "GPU-a"], ["GPU-b"]], "nccl"),          # a card repeated in one process
    ([["GPU-a"], ["cpu"]], "gloo"),
])
def test_data_backend_rule(identities, want):
    from seekr_tpu_torch.parallel.comm import data_backend

    assert data_backend(identities) == want


def test_addressable_shards_of_a_mesh_across_processes():
    # positions of process 1 are held elsewhere: this process fills its own only
    mesh = mesh_mod.Mesh([[CPU]] * 4, owners=[[0], [1], [0], [1]])
    assert mesh.spans_processes and mesh.local_positions == [(0, 0), (2, 0)]
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    t = shard(x, data_sharding(mesh))
    assert not t.is_fully_addressable and t.addressable_shards is t.shards
    assert [s.index[0] for s in t.addressable_shards] == [slice(0, 2), slice(4, 6)]
    np.testing.assert_array_equal(t.addressable_shards[1].data.numpy(), x[4:6])
    with pytest.raises(RuntimeError, match="spans the devices of several processes"):
        np.asarray(t)
    np.testing.assert_array_equal(np.asarray(shard(x, replicated(mesh))), x)
    assert shard(x, data_sharding(port_mesh())).is_fully_addressable
    with pytest.raises(ValueError, match="owns no position"):
        mesh_mod.Mesh([[CPU]] * 2, owners=[[1], [1]])


# -- the sharded count and the statistics -------------------------------------

@pytest.mark.parametrize("k,flat_out", [(3, True), (4, False)])
def test_sharded_count_is_bitwise_per_shard(k, flat_out):
    bases, lengths = batch(16, 200, k, seed=k)
    parts = dist._sharded_count(port_mesh(), bases, lengths, k, flat=flat_out)
    assert len(parts) == 8
    for i, part in enumerate(parts):
        rows = slice(2 * i, 2 * i + 2)
        want = count_torch(torch.from_numpy(bases[rows]), torch.from_numpy(lengths[rows]), k,
                           flat=flat_out)
        assert torch.equal(part, want)


@pytest.mark.parametrize("log2", ["Log2.none", "Log2.pre", "Log2.post"])
def test_norm_stats_match_seekr_tpu_and_one_device(log2):
    k = 2
    bases, lengths = batch(24, 128, k, seed=3)
    mean, std = dist.distributed_norm_stats(port_mesh(), k=k, log2=log2)(bases, lengths)
    jmean, jstd = jax_dist.distributed_norm_stats(jax_mesh(), k=k, log2=log2)(bases, lengths)
    np.testing.assert_allclose(np.asarray(mean), np.asarray(jmean), **NORM_TOL)
    np.testing.assert_allclose(np.asarray(std), np.asarray(jstd), **NORM_TOL)
    raw = count_torch(torch.from_numpy(bases), torch.from_numpy(lengths), k)
    # one device: the same statistics (Log2.pre before them), computed whole
    _, m1, s1 = normalize_counts(raw, log2_mode="Log2.pre" if log2 == "Log2.pre"
                                 else "Log2.none")
    np.testing.assert_allclose(np.asarray(mean), m1.numpy(), **NORM_TOL)
    np.testing.assert_allclose(np.asarray(std), s1.numpy(), **NORM_TOL)


# -- the pipeline ---------------------------------------------------------------

@pytest.mark.parametrize("kp", [1, 2], ids=["8x1", "4x2"])
@pytest.mark.parametrize("log2", ["Log2.post", "Log2.pre", "Log2.none"])
def test_pipeline_matches_seekr_tpu(kp, log2):
    k = 3
    bases, lengths = batch(16, 128, k)
    got = dist.distributed_pipeline(port_mesh(kp), k=k, log2=log2)(bases, lengths)
    want = jax_dist.distributed_pipeline(jax_mesh(kp), k=k, log2=log2)(bases, lengths)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(flat(g), flat(w), **NORM_TOL)
    np.testing.assert_allclose(np.asarray(got[3]), np.asarray(want[3]), **R_TOL)
    assert got[0].sharding.spec == ("data", "kmer") and got[3].sharding.spec == ("data", None)
    assert got[0].shards[0].data.shape == (16 // (8 // kp), 64 // kp)
    # against the port on one device, normalize and Pearson computed whole
    raw = count_torch(torch.from_numpy(bases), torch.from_numpy(lengths), k)
    norm, mean, std = normalize_counts(raw, log2_mode=log2)
    np.testing.assert_allclose(np.asarray(got[0]), norm.numpy(), **NORM_TOL)
    np.testing.assert_allclose(np.asarray(got[1]), mean.numpy(), **NORM_TOL)
    np.testing.assert_allclose(np.asarray(got[2]), std.numpy(), **NORM_TOL)
    np.testing.assert_allclose(np.asarray(got[3]), pearson_device(norm, norm, device=CPU),
                               **R_TOL)


def test_pipeline_nan_from_a_zero_std_column():
    """A k-mer absent from every row has std 0; Log2.post's global min then
    spreads the NaN over the whole matrix, as on one device.  seekr_tpu's mesh
    does not: its cross-shard min drops the NaN (inf and NaN cells), so the
    port is held to seekr_tpu's single-device ``normalize_counts`` here, and to
    its mesh for the statistics."""
    from seekr_tpu.ops.count import count_kmers_device as jax_count
    from seekr_tpu.ops.normalize import normalize_counts as jax_normalize

    k = 2
    bases, lengths = batch(16, 64, k, seed=5)
    bases[bases == 3] = 0  # no C: every column with a C has std 0
    got = dist.distributed_pipeline(port_mesh(2), k=k)(bases, lengths)
    want = jax_dist.distributed_pipeline(jax_mesh(2), k=k)(bases, lengths)
    one, _, _ = jax_normalize(jax_count(bases, lengths, k))
    assert np.isnan(np.asarray(one)).all() and np.isnan(np.asarray(got[0])).all()
    assert not np.isnan(np.asarray(want[0])).all()  # seekr_tpu's mesh
    assert np.isnan(np.asarray(got[3])).all()
    for g, w in zip(got[1:3], want[1:3]):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), **NORM_TOL)


def test_pipeline_unflattened_and_norm_vectors():
    k = 4
    bases, lengths = batch(16, 160, k, seed=1)
    rng = np.random.default_rng(3)
    mean_vec = rng.uniform(10, 50, size=4 ** k).astype(np.float32)
    std_vec = rng.uniform(0.5, 3.0, size=4 ** k).astype(np.float32)
    ref = dist.distributed_pipeline(port_mesh(2), k=k)(bases, lengths)
    three = dist.distributed_pipeline(port_mesh(2), k=k, flat=False)(bases, lengths)
    c3 = np.asarray(three[0])
    assert c3.ndim == 3 and three[1].ndim == 1
    np.testing.assert_allclose(c3.reshape(16, -1), np.asarray(ref[0]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(three[3]), np.asarray(ref[3]), **R_TOL)

    vec = dist.distributed_pipeline(port_mesh(2), k=k, use_norm_vectors=True)
    got = vec(bases, lengths, mean_vec, std_vec)
    want = jax_dist.distributed_pipeline(jax_mesh(2), k=k, use_norm_vectors=True)(
        bases, lengths, mean_vec, std_vec)
    assert got[1].sharding.spec == ("kmer",)
    np.testing.assert_array_equal(np.asarray(got[1]), mean_vec)
    for g, w in zip(got, want):
        np.testing.assert_allclose(flat(g), flat(w), **NORM_TOL)
    got3 = dist.distributed_pipeline(port_mesh(2), k=k, use_norm_vectors=True, flat=False)(
        bases, lengths, mean_vec, std_vec)
    np.testing.assert_allclose(np.asarray(got3[0]).reshape(16, -1), np.asarray(got[0]),
                               rtol=1e-5, atol=1e-5)


def test_pipeline_divisibility_errors():
    with pytest.raises(ValueError, match="requires divisibility; choose a power-of-two"):
        dist.distributed_pipeline(make_mesh([CPU] * 6, kmer_parallel=3), k=3)
    step = dist.distributed_pipeline(port_mesh(8), k=2, flat=False)
    with pytest.raises(ValueError, match="n_hi"):
        step(*batch(16, 128, 2))
    with pytest.raises(ValueError, match="do not divide over the 8-device data axis"):
        dist.distributed_pipeline(port_mesh(), k=2)(*batch(12, 64, 2))


# -- the long sequence ------------------------------------------------------------

@pytest.mark.parametrize("length", [10_000, 333])
def test_count_long_sequence_is_bitwise_seekr_tpus(length):
    from seekr_tpu.io.encode import encode_seq

    k = 6
    rng = np.random.default_rng(7)
    seq = "".join(rng.choice(list("AGTCN"), size=length, p=[0.24] * 4 + [0.04]))
    digits = encode_seq(seq)
    chunks, n_windows = dist.shard_long_sequence(digits, k, 8)
    got = dist.count_long_sequence(port_mesh(2), k)(chunks, np.float32(n_windows))
    want = np.asarray(jax_dist.count_long_sequence(jax_mesh(), k)(chunks, np.float32(n_windows)))
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)


def test_count_long_sequence_shorter_than_k_is_zeros():
    for digits in (np.array([], np.int8), np.array([0, 1], np.int8)):
        chunks, n_windows = dist.shard_long_sequence(digits, 3, 8)
        assert n_windows <= 0
        out = dist.count_long_sequence(port_mesh(), 3)(chunks, np.int32(n_windows)).numpy()
        assert out.shape == (64,) and (out == 0).all()
    with pytest.raises(ValueError, match="chunks for a 8-device mesh"):
        dist.count_long_sequence(port_mesh(), 3)(np.zeros((4, 5), np.int8), 10)


# -- the streamed Pearson ----------------------------------------------------------

@pytest.mark.parametrize("kp", [1, 2], ids=["8x1", "4x2"])
@pytest.mark.parametrize("block_rows", [4, 5, 100])
@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
def test_stream_pearson_sharded_matches_seekr_tpu(kp, block_rows, cross):
    rng = np.random.default_rng(3)
    c1 = rng.normal(size=(13, 64)).astype(np.float32)  # 13 and 11 rows: indivisible
    c2 = rng.normal(size=(11, 64)).astype(np.float32) if cross else None
    got, want = ArrayCollector(), ArrayCollector()
    dist.stream_pearson_sharded(port_mesh(kp), c1, got, block_rows=block_rows, counts2=c2)
    jax_dist.stream_pearson_sharded(jax_mesh(kp), c1, want, block_rows=block_rows,
                                    counts2=c2)
    assert got.result().shape == (13, 11 if cross else 13)
    np.testing.assert_allclose(got.result(), want.result(), **R_TOL)
    other = c1 if c2 is None else c2
    np.testing.assert_allclose(got.result(), pearson_device(c1, other, device=CPU).numpy(),
                               rtol=0, atol=1e-6)


def test_stream_pearson_sharded_takes_tensors_on_any_device():
    c = torch.from_numpy(np.random.default_rng(4).normal(size=(9, 32)).astype(np.float32))
    got = ArrayCollector()
    dist.stream_pearson_sharded(port_mesh(), c, got, block_rows=4)
    np.testing.assert_allclose(got.result(), pearson_device(c, c, device=CPU).numpy(),
                               rtol=0, atol=1e-6)


# -- the sharded scorer --------------------------------------------------------------

def scorer_inputs(n_t=13, n_cols=64, n_q=5, seed=7):
    rng = np.random.default_rng(seed)
    targets = rng.normal(size=(n_t, n_cols)).astype(np.float32)
    # planted exact ties, crossing shard boundaries (2 rows per shard at 13 -> 16)
    targets[5] = targets[1]
    targets[9] = targets[1]
    targets[12] = targets[2]
    qc = rng.normal(size=(n_q, n_cols)).astype(np.float32)
    qc[3] = targets[1]  # its best match is a three-way tie across three shards
    return targets, qc


def test_sharded_scorer_matches_seekr_tpu_and_one_device():
    from seekr_tpu.ops.pearson import standardize_rows as jax_standardize_rows

    targets, qc = scorer_inputs()
    tstd = standardize_rows(targets, device=CPU)
    scorer = dist.make_sharded_scorer(port_mesh(2), tstd)
    ref = jax_dist.make_sharded_scorer(jax_mesh(), np.asarray(jax_standardize_rows(targets)))
    one = pearson_device(qc, targets, device=CPU).numpy()
    assert scorer.t_real == 13 and scorer.t_loc == 2 and scorer.sim(qc).shape == (5, 16)
    np.testing.assert_allclose(scorer.sim_host(qc), one, rtol=0, atol=1e-6)
    np.testing.assert_allclose(scorer.sim_host(qc), ref.sim_host(qc), rtol=0, atol=1e-6)
    for n in (1, 2, 3, 4, 7, 100):
        vals, idx = scorer.topk(qc, n)
        jvals, jidx = (np.asarray(a) for a in ref.topk(qc, n))
        assert np.array_equal(idx.numpy(), jidx)
        np.testing.assert_allclose(vals.numpy(), jvals, rtol=0, atol=1e-6)
        # ties at the lower global index: a stable descending sort of the sim
        want = np.argsort(-scorer.sim_host(qc), axis=1, kind="stable")[:, :min(n, 13)]
        assert np.array_equal(idx.numpy(), want)
    assert scorer.topk(qc, 3)[1][3].tolist() == [1, 5, 9]
    sim, vals, idx = scorer.sim_and_topk(qc, 4)
    np.testing.assert_array_equal(np.asarray(sim)[:, :13], scorer.sim_host(qc))
    assert np.array_equal(idx.numpy(), scorer.topk(qc, 4)[1].numpy())


def test_sharded_scorer_grows_and_reloads():
    targets, qc = scorer_inputs(n_t=20)
    scorer = dist.ShardedScorer(port_mesh(), standardize_rows(targets, device=CPU),
                                row_quantum=32)
    assert (scorer.t_loc, scorer.prospective_rows(33)) == (4, 64)
    before = scorer.sim_host(qc)
    more = standardize_rows(np.random.default_rng(1).normal(size=(10, 64)), device=CPU)
    assert scorer.grow(more) == 30 and scorer.t_loc == 4  # within the quantum
    after = scorer.sim_host(qc)
    assert np.array_equal(after[:, :20], before)  # bitwise
    np.testing.assert_allclose(after[:, 20:], pearson_device(qc, more, device=CPU).numpy(),
                               rtol=0, atol=1e-6)
    assert scorer.grow(more) == 40 and scorer.t_loc == 8  # across it
    assert scorer.topk(qc, 40)[1].max() < 40
    np.testing.assert_array_equal(scorer.host_corpus[20:30], more.numpy())
    scorer.reload(scorer.host_corpus[:20])
    assert scorer.t_real == 20 and np.array_equal(scorer.sim_host(qc), before)


def test_sharded_scorer_grow_failure_keeps_the_old_corpus(monkeypatch):
    targets, qc = scorer_inputs()
    scorer = dist.ShardedScorer(port_mesh(), targets)
    before = scorer.sim_host(qc)
    load = dist.ShardedScorer._load

    def fail_on_growth(self, host):
        if host.shape[0] > 13:
            raise MemoryError("out of device memory")
        load(self, host)

    monkeypatch.setattr(dist.ShardedScorer, "_load", fail_on_growth)
    with pytest.raises(MemoryError):
        scorer.grow(targets[:3])
    assert scorer.t_real == 13 and np.array_equal(scorer.sim_host(qc), before)


def test_port_parallel_exports_seekr_tpus_names():
    import seekr_tpu.parallel as jax_parallel
    import seekr_tpu_torch.parallel as parallel

    assert set(jax_parallel.__all__) <= set(parallel.__all__)
    assert mesh_mod.DATA_AXIS == "data" and mesh_mod.KMER_AXIS == "kmer"
