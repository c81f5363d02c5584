"""The port's mesh across processes (``parallel.comm`` + ``parallel.dist``), on
the CPU: fresh processes on 127.0.0.1, each holding ``[cpu] * 4``, joined by
``init_distributed`` over gloo, as seekr_tpu's
``tests/test_distributed_multiprocess.py`` joins ``jax.distributed`` processes.

The worker code lives in this file: ``python test_torch_multiprocess.py ROLE
COORDINATOR N PID OUT`` runs one process of a case (ROLE one of ``pipeline``,
``pod``, ``liveness``, ``leader_death``, ``soak``); the tests start the
processes, bound each wait with its own timeout and kill every child on the
way out, so a case never hangs the suite.  Tolerances:

  * the pipeline, norm stats, long sequence: each process's shards bitwise
    the port's one-process mesh of the same grid (sim within 1e-6); against
    seekr_tpu's 8-device mesh (2 processes) rtol 1e-4 / atol 1e-5, r 1e-4; the
    float64 host oracle as ``tests/dist_worker.py`` holds it;
  * ``stream_pearson_sharded``: every process's writer receives every tile,
    bitwise the one-process mesh's;
  * pod serving: sim within 1e-6 of the port's single-device service and of
    seekr_tpu's (before a grow, after it and after an unwound grow), top-k
    indices equal.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve()
ROOT = HERE.parents[1]
K, M, L = 3, 16, 128          # the pipeline case of tests/dist_worker.py
SHARDS_PER_PROCESS = 4
POD_K = 4


# -- inputs, made alike in every process from seeds ----------------------------

def pipeline_inputs():
    rng = np.random.default_rng(0)
    bases = rng.integers(0, 4, size=(M, L), dtype=np.int8)
    lengths = rng.integers(K + 1, L + 1, size=M).astype(np.int32)
    for r in range(M):
        bases[r, lengths[r]:] = 4
    return bases, lengths


def stream_inputs():
    rng = np.random.default_rng(1)
    return (rng.normal(size=(13, 64)).astype(np.float32),
            rng.normal(size=(11, 64)).astype(np.float32))


def long_sequence():
    rng = np.random.default_rng(5)
    return rng.integers(0, 4, size=4096, dtype=np.int8)


def seqs_of(rng, n, lo=80, hi=240):
    letters = np.array(list("AGTC"))
    return ["".join(letters[rng.integers(0, 4, rng.integers(lo, hi))]) for _ in range(n)]


def pod_vectors(rng, k):
    return (rng.normal(1.0, 0.1, 4 ** k).astype(np.float32),
            rng.normal(1.0, 0.05, 4 ** k).astype(np.float32))


class Tiles:
    def __init__(self):
        self.blocks = []

    def append(self, tile):
        self.blocks.append(np.asarray(tile))


def run_mesh_functions(mesh, device):
    """The four mesh functions of the pipeline case on ``mesh``: a dict of
    this process's shards (``{name}@{i},{j}`` keys) and whole replicated
    results."""
    from seekr_tpu_torch.parallel import dist

    bases, lengths = pipeline_inputs()
    bases_t, lengths_t = torch.as_tensor(bases, device=device), torch.as_tensor(lengths,
                                                                                device=device)
    counts, mean, std, sim = dist.distributed_pipeline(mesh, k=K)(bases_t, lengths_t)
    nmean, nstd = dist.distributed_norm_stats(mesh, k=K, log2="Log2.none")(bases_t, lengths_t)
    chunks, n_windows = dist.shard_long_sequence(long_sequence(), K, mesh.size)
    row = dist.count_long_sequence(mesh, K)(chunks, np.float32(n_windows))
    s1, s2 = stream_inputs()
    tiles = Tiles()
    dist.stream_pearson_sharded(mesh, s1, tiles, block_rows=5, counts2=s2)
    out = {}
    for name, tensor in (("counts", counts), ("sim", sim)):
        for s in tensor.addressable_shards:
            out[f"{name}@{s.index[0].start},{s.index[1].start}"] = s.data.cpu().numpy()
    for name, tensor in (("mean", mean), ("std", std), ("norm_mean", nmean),
                         ("norm_std", nstd)):
        out[name] = tensor.addressable_shards[0].data.cpu().numpy()
    out["long_row"] = row.cpu().numpy()
    out["stream"] = np.vstack(tiles.blocks)
    return out


# -- worker roles ---------------------------------------------------------------

def worker_pipeline(coordinator, n, pid, out_dir, device="cpu"):
    from seekr_tpu_torch.parallel import comm
    from seekr_tpu_torch.parallel.mesh import make_mesh

    comm.init_distributed(coordinator, n, pid, device=device)
    assert comm.process_count() == n and comm.process_index() == pid
    mesh = make_mesh([torch.device(device)] * SHARDS_PER_PROCESS)
    assert mesh.size == SHARDS_PER_PROCESS * n and mesh.spans_processes
    assert len(mesh.local_positions) == SHARDS_PER_PROCESS
    results = run_mesh_functions(mesh, device)
    np.savez(os.path.join(out_dir, f"p{pid}.npz"), **results)
    print(json.dumps({"backends": comm.backends()}), flush=True)
    print(f"WORKER_OK p{pid}", flush=True)


def pod_service(pid, n, coordinator, targets, mean, std, k, **kwargs):
    from seekr_tpu_torch.parallel import comm
    from seekr_tpu_torch.parallel.mesh import make_mesh
    from seekr_tpu_torch.serve import SeekrService

    comm.init_distributed(coordinator, n, pid, device="cpu")
    mesh = make_mesh([torch.device("cpu")] * SHARDS_PER_PROCESS)
    return SeekrService(mean, std, k=k, targets=targets, mesh=mesh, device="cpu", **kwargs)


def pod_inputs():
    """(targets, queries, extra, mean, std, failed) of the pod case; ``failed``
    are the rows of the grow that fails."""
    rng = np.random.default_rng(7)
    targets, queries, extra = seqs_of(rng, 13), seqs_of(rng, 3), seqs_of(rng, 4)
    mean, std = pod_vectors(rng, POD_K)
    return targets, queries, extra, mean, std, seqs_of(rng, 2)


def worker_pod(coordinator, n, pid, out_dir):
    """seekr_tpu's tests/pod_worker.py: the leader's answers against a local
    single-device service, a grow to 17 targets, a grow that fails on the
    leader only, and calls after stop.  The leader writes its answers to
    ``pod_leader.npz`` for the parent to hold against seekr_tpu."""
    from seekr_tpu_torch.parallel.dist import PodScorer
    from seekr_tpu_torch.serve import SeekrService

    targets, queries, extra, mean, std, failed = pod_inputs()
    svc = pod_service(pid, n, coordinator, targets, mean, std, POD_K)
    assert isinstance(svc._scorer, PodScorer), type(svc._scorer)
    if pid != 0:
        svc.follow()  # mirrors until the leader stops
        assert svc._scorer.t_real == 17  # the failed grow was unwound here too
        print(f"WORKER_OK p{pid}", flush=True)
        return

    oracle = SeekrService(mean, std, k=POD_K, targets=targets, device="cpu")
    got = svc.query(queries, want=("sim", "topk"), topk=5)
    want = oracle.query(queries, want=("sim", "topk"), topk=5)
    assert np.abs(got["sim"] - want["sim"]).max() <= 1e-6
    assert np.array_equal(got["topk_idx"], want["topk_idx"])

    assert svc.add_targets(extra) == (17, 4)
    oracle.add_targets(extra)
    got2 = svc.query(queries, want=("sim", "topk"), topk=17)
    want2 = oracle.query(queries, want=("sim", "topk"), topk=17)
    assert np.asarray(got2["sim"]).shape == (3, 17)
    assert np.abs(got2["sim"] - want2["sim"]).max() <= 1e-6
    assert np.array_equal(got2["topk_idx"], want2["topk_idx"])
    got3 = svc.query(queries, want=("topk",), topk=2)
    assert np.array_equal(got3["topk_idx"], np.asarray(want2["topk_idx"])[:, :2])

    # the leader's re-shard fails while the follower's succeeds: the vote
    # unwinds the follower, and the pod answers from the old corpus
    inner = svc._scorer._scorer
    real_grow = inner.grow

    def boom(rows):
        raise MemoryError("induced grow failure")

    inner.grow = boom
    try:
        svc.add_targets(failed)
        raise SystemExit("expected the induced grow failure to raise")
    except MemoryError:
        pass
    inner.grow = real_grow
    assert svc._scorer.t_real == 17
    got4 = svc.query(queries, want=("sim", "topk"), topk=3)
    assert np.abs(got4["sim"] - want2["sim"]).max() <= 1e-6
    assert np.array_equal(got4["topk_idx"], np.asarray(want2["topk_idx"])[:, :3])

    svc.stop_followers()
    svc.stop_followers()  # idempotent: a second STOP must not hang
    try:
        svc.query(queries, want=("topk",), topk=2)
        raise SystemExit("expected a query after stop to fail")
    except RuntimeError as err:
        assert "stopped" in str(err), err
    np.savez(os.path.join(out_dir, "pod_leader.npz"),
             sim_13=got["sim"], topk5_13=got["topk_idx"], sim_17=got2["sim"],
             topk17_17=got2["topk_idx"], topk2_17=got3["topk_idx"],
             sim_unwound=got4["sim"], topk3_unwound=got4["topk_idx"])
    print("WORKER_OK p0", flush=True)


def serve_in_thread(svc, sock):
    from seekr_tpu_torch.serve import serve_forever

    ready = threading.Event()
    srv = threading.Thread(target=serve_forever, args=(svc, sock, ready), daemon=True)
    srv.start()
    assert ready.wait(60)
    return srv


def worker_liveness(coordinator, n, pid, out_dir):
    """seekr_tpu's tests/pod_liveness_worker.py: the test SIGKILLs the follower;
    the leader's socket client gets an "unresponsive" error within the
    watchdog's deadline, later requests fail fast, shutdown does not hang."""
    from seekr_tpu_torch.serve import request

    rng = np.random.default_rng(11)
    targets, queries = seqs_of(rng, 10), seqs_of(rng, 2)
    mean, std = pod_vectors(rng, K)
    svc = pod_service(pid, n, coordinator, targets, mean, std, K)
    if pid != 0:
        svc.follow()  # never returns normally: the test kills this process
        return
    sock = os.path.join(out_dir, "pod.sock")
    srv = serve_in_thread(svc, sock)
    resp = request(sock, {"seqs": queries, "want": ["topk"], "topk": 3})
    assert resp["ok"], resp
    Path(out_dir, "warm").touch()
    deadline = time.time() + 60
    while not Path(out_dir, "killed").exists():
        if time.time() > deadline:
            raise SystemExit("the follower was never killed")
        time.sleep(0.05)
    t0 = time.time()
    resp = request(sock, {"seqs": queries, "want": ["topk"], "topk": 3}, timeout=30)
    elapsed = time.time() - t0
    assert resp["ok"] is False and "unresponsive" in resp["error"], resp
    assert elapsed < float(os.environ["SEEKR_TPU_POD_TIMEOUT"]) + 5, elapsed
    t0 = time.time()
    resp = request(sock, {"seqs": queries, "want": ["sim"]}, timeout=30)
    assert resp["ok"] is False and "dead" in resp["error"], resp
    assert time.time() - t0 < 5
    assert request(sock, {"op": "shutdown"})["ok"]
    srv.join(timeout=20)
    assert not srv.is_alive()
    print(f"LIVENESS_OK p0 {elapsed:.2f}", flush=True)
    sys.stdout.flush()
    os._exit(0)  # the process group's peer is dead by design


def worker_leader_death(coordinator, n, pid, out_dir):
    """seekr_tpu's tests/pod_leader_death_worker.py: the test SIGKILLs the idle
    leader after an idle time longer than the follower's header timeout (the
    heartbeats keep it following); the follower is then released."""
    rng = np.random.default_rng(13)
    mean, std = pod_vectors(rng, K)
    svc = pod_service(pid, n, coordinator, seqs_of(rng, 8), mean, std, K)
    if pid == 0:
        out = svc.query(seqs_of(rng, 2), want=("topk",), topk=3)
        assert out["topk_idx"] is not None
        Path(out_dir, "warm").touch()
        time.sleep(3600)  # idle, heartbeating, until killed
        return
    t0 = time.time()
    try:
        svc.follow()
        print("FOLLOW_RETURNED_UNEXPECTEDLY", flush=True)
    except RuntimeError as err:
        print(f"FOLLOWER_RELEASED after {time.time() - t0:.1f}s ({err})", flush=True)
    sys.stdout.flush()
    os._exit(0)


def worker_soak(coordinator, n, pid, out_dir):
    """seekr_tpu's tests/pod_soak_worker.py: 4 socket clients of mixed requests,
    grows riding the same channel, heartbeats throughout, a clean shutdown."""
    from seekr_tpu_torch.serve import request

    rng = np.random.default_rng(17)
    mean, std = pod_vectors(rng, K)
    svc = pod_service(pid, n, coordinator, seqs_of(rng, 11), mean, std, K, grow_quantum=16)
    if pid != 0:
        svc.follow()
        print(f"WORKER_OK p{pid}", flush=True)
        return
    sock = os.path.join(out_dir, "soak.sock")
    srv = serve_in_thread(svc, sock)
    errors = []

    def client(cid):
        crng = np.random.default_rng(100 + cid)
        try:
            for i in range(12):
                want = ["topk"] if crng.integers(0, 2) else ["sim"]
                resp = request(sock, {"seqs": seqs_of(crng, int(crng.integers(1, 4))),
                                      "want": want, "topk": 4}, timeout=120)
                assert resp["ok"], resp
                if "topk_idx" in resp:
                    # indices point at real targets, never at a pad row, mid-grow too
                    assert np.asarray(resp["topk_idx"]).max() < resp["n"]
                else:
                    assert len(resp["sim"][0]) == resp["n"]
                if cid == 0 and i % 4 == 1:
                    grown = request(sock, {"op": "add_targets", "seqs": seqs_of(crng, 2)},
                                    timeout=120)
                    assert grown["ok"], grown
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(f"client {cid}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive(), "a client wedged"
    assert not errors, errors
    pong = request(sock, {"op": "ping"})
    assert pong["ok"] and pong["queries_served"] >= 48 and pong["targets"] == 17, pong
    assert request(sock, {"op": "shutdown"})["ok"]
    srv.join(timeout=60)
    assert not srv.is_alive()
    print("WORKER_OK p0", flush=True)


ROLES = {"pipeline": worker_pipeline, "pod": worker_pod, "liveness": worker_liveness,
         "leader_death": worker_leader_death, "soak": worker_soak}


# -- the parent's side ------------------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start(role, n, out_dir, env_extra=None, args=()):
    coordinator = f"127.0.0.1:{free_port()}"
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"), "PYTHONPATH": str(ROOT),
           "OMP_NUM_THREADS": "1", **(env_extra or {})}
    return [subprocess.Popen([sys.executable, str(HERE), role, coordinator, str(n), str(pid),
                              str(out_dir), *args],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                             env=env)
            for pid in range(n)]


def finish(procs, timeout):
    """Each process's (return code, output), waiting at most ``timeout`` s in
    all; every process still running after that is killed, and the case fails."""
    outs = []
    deadline = time.time() + timeout
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.time()))
            outs.append((p.returncode, out))
    except subprocess.TimeoutExpired:
        kill(procs)
        pytest.fail("workers timed out:\n" + "\n".join(p.communicate()[0] or "" for p in procs))
    return outs


def kill(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait(timeout=30)


def run_workers(role, n, out_dir, timeout=90, env_extra=None, args=()):
    procs = start(role, n, out_dir, env_extra, args)
    try:
        outs = finish(procs, timeout)
    finally:
        kill(procs)
    for pid, (rc, out) in enumerate(outs):
        assert rc == 0, f"worker {pid} failed:\n{out}"
        assert f"WORKER_OK p{pid}" in out, f"worker {pid} output:\n{out}"
    return [out for _, out in outs]


def wait_for(path, procs, timeout):
    deadline = time.time() + timeout
    while not path.exists():
        for p in procs:
            if p.poll() is not None:
                pytest.fail(f"a worker died before {path.name}:\n{p.communicate()[0]}")
        if time.time() > deadline:
            pytest.fail(f"no {path.name} within {timeout} s")
        time.sleep(0.1)


def one_process_reference(n, device="cpu"):
    """The port's one-process mesh of the same grid: n * 4 shards, the shard
    keys of ``run_mesh_functions``."""
    from seekr_tpu_torch.parallel.mesh import make_mesh

    return run_mesh_functions(make_mesh([torch.device(device)] * (SHARDS_PER_PROCESS * n)),
                              device)


def check_against_one_process(parts, ref):
    """Every shard of every process against the one-process mesh: bitwise, the
    similarity within 1e-6; the replicated results and the streamed tiles on
    every process."""
    shards = {}
    for part in parts:
        for key in part.files:
            if "@" in key:
                assert key not in shards, f"two processes hold {key}"
                shards[key] = part[key]
            elif key == "sim":
                continue
            else:
                np.testing.assert_array_equal(part[key], ref[key], err_msg=key)
    assert sorted(shards) == sorted(k for k in ref if "@" in k)
    for key, got in shards.items():
        if key.startswith("sim@"):
            assert np.abs(got - ref[key]).max() <= 1e-6, key
        else:
            np.testing.assert_array_equal(got, ref[key], err_msg=key)


def assemble(parts, name, shape):
    out = np.full(shape, np.nan, np.float32)
    for part in parts:
        for key in part.files:
            if key.startswith(name + "@"):
                i, j = (int(v) for v in key.split("@")[1].split(","))
                block = part[key]
                out[i:i + block.shape[0], j:j + block.shape[1]] = block
    return out


@pytest.mark.parametrize("n_procs", [2, 4])
def test_mesh_across_processes_is_the_one_process_mesh(tmp_path, n_procs):
    outs = run_workers("pipeline", n_procs, tmp_path)
    assert all('"data": "gloo"' in out for out in outs)
    parts = [np.load(tmp_path / f"p{pid}.npz") for pid in range(n_procs)]
    ref = one_process_reference(n_procs)
    check_against_one_process(parts, ref)

    # the float64 host oracle (tests/dist_worker.py's tolerances)
    from seekr_tpu_torch.ops.count import count_kmers_host

    bases, lengths = pipeline_inputs()
    seqs = ["".join(np.array(list("AGTC"))[bases[r, :lengths[r]]]) for r in range(M)]
    raw = count_kmers_host(seqs, K).astype(np.float64)
    c = (raw - raw.mean(axis=0)) / raw.std(axis=0)
    c = np.log2(c + np.abs(c.min()) + 1)
    cs = (c - c.mean(axis=1, keepdims=True)) / c.std(axis=1, keepdims=True)
    counts = assemble(parts, "counts", (M, 4 ** K))
    sim = assemble(parts, "sim", (M, M))
    np.testing.assert_allclose(counts, c, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(sim, cs @ cs.T / c.shape[1], rtol=1e-3, atol=1e-4)
    for part in parts:
        np.testing.assert_allclose(part["norm_mean"], raw.mean(axis=0), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(part["norm_std"], raw.std(axis=0), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(part["long_row"],
                                   count_kmers_host(["".join(np.array(list("AGTC"))[
                                       long_sequence()])], K)[0], rtol=1e-4, atol=1e-3)
        s1, s2 = (x.astype(np.float64) for x in stream_inputs())
        z1 = (s1 - s1.mean(1, keepdims=True)) / s1.std(1, keepdims=True)
        z2 = (s2 - s2.mean(1, keepdims=True)) / s2.std(1, keepdims=True)
        np.testing.assert_allclose(part["stream"], z1 @ z2.T / 64, rtol=1e-4, atol=1e-5)

    if n_procs == 2:  # seekr_tpu's 8-device mesh, the same grid
        import jax

        from seekr_tpu.parallel import dist as jax_dist
        from seekr_tpu.parallel.mesh import make_mesh as jax_make_mesh

        jmesh = jax_make_mesh(jax.devices()[:8])
        jcounts, jmean, jstd, jsim = jax_dist.distributed_pipeline(jmesh, k=K)(bases, lengths)
        np.testing.assert_allclose(counts, np.asarray(jcounts), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(sim, np.asarray(jsim), rtol=0, atol=1e-4)
        np.testing.assert_allclose(parts[1]["mean"], np.asarray(jmean), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(parts[1]["std"], np.asarray(jstd), rtol=1e-4, atol=1e-5)
        jm, js = jax_dist.distributed_norm_stats(jmesh, k=K, log2="Log2.none")(bases, lengths)
        np.testing.assert_allclose(parts[0]["norm_mean"], np.asarray(jm), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(parts[0]["norm_std"], np.asarray(js), rtol=1e-4, atol=1e-5)
        chunks, n_windows = jax_dist.shard_long_sequence(long_sequence(), K, 8)
        jrow = jax_dist.count_long_sequence(jmesh, K)(chunks, np.float32(n_windows))
        np.testing.assert_allclose(parts[1]["long_row"], np.asarray(jrow), rtol=1e-4, atol=1e-5)
        s1, s2 = stream_inputs()
        jtiles = Tiles()
        jax_dist.stream_pearson_sharded(jmesh, s1, jtiles, block_rows=5, counts2=s2)
        np.testing.assert_allclose(parts[0]["stream"], np.vstack(jtiles.blocks), rtol=0,
                                   atol=1e-4)


def test_pod_serving_matches_one_device(tmp_path):
    run_workers("pod", 2, tmp_path)
    # the leader's answers against seekr_tpu's single-device service on the
    # same inputs: before the grow, after it, and after the unwound grow
    from seekr_tpu import serve as jax_serve

    targets, queries, extra, mean, std, _ = pod_inputs()
    got = np.load(tmp_path / "pod_leader.npz")
    ref = jax_serve.SeekrService(mean, std, k=POD_K, targets=targets)
    want = ref.query(queries, want=("sim", "topk"), topk=5)
    assert np.abs(got["sim_13"] - np.asarray(want["sim"])).max() <= 1e-6
    np.testing.assert_array_equal(got["topk5_13"], np.asarray(want["topk_idx"]))
    assert ref.add_targets(extra) == (17, 4)
    want = ref.query(queries, want=("sim", "topk"), topk=17)
    for name in ("sim_17", "sim_unwound"):
        assert got[name].shape == (3, 17)
        assert np.abs(got[name] - np.asarray(want["sim"])).max() <= 1e-6, name
    for name, n in (("topk17_17", 17), ("topk2_17", 2), ("topk3_unwound", 3)):
        np.testing.assert_array_equal(got[name], np.asarray(want["topk_idx"])[:, :n],
                                      err_msg=name)


def test_pod_killed_follower_is_reported(tmp_path):
    procs = start("liveness", 2, tmp_path, {"SEEKR_TPU_POD_TIMEOUT": "3"})
    try:
        wait_for(tmp_path / "warm", procs, 60)
        procs[1].send_signal(signal.SIGKILL)
        procs[1].wait(timeout=30)
        (tmp_path / "killed").touch()
        out, _ = procs[0].communicate(timeout=40)
        assert procs[0].returncode == 0 and "LIVENESS_OK p0" in out, out
    finally:
        kill(procs)


def test_pod_killed_leader_releases_the_follower(tmp_path):
    # timeout 2 s: a PING every second, the follower's header wait 6 s
    procs = start("leader_death", 2, tmp_path, {"SEEKR_TPU_POD_TIMEOUT": "2"})
    try:
        wait_for(tmp_path / "warm", procs, 60)
        time.sleep(7)  # idle longer than the header wait: the heartbeats keep it
        assert procs[1].poll() is None, procs[1].communicate()[0]
        procs[0].send_signal(signal.SIGKILL)
        procs[0].wait(timeout=30)
        t0 = time.time()
        out, _ = procs[1].communicate(timeout=30)
        assert procs[1].returncode == 0 and "FOLLOWER_RELEASED" in out, out
        assert time.time() - t0 < 10, out
    finally:
        kill(procs)


def test_pod_soak(tmp_path):
    run_workers("soak", 2, tmp_path, env_extra={"SEEKR_TPU_POD_TIMEOUT": "6"})


@pytest.mark.gpu
def test_gpu_two_processes_share_one_card(tmp_path):
    """Two processes on cuda:0: a shared card, so the data group is gloo,
    staged through pinned host memory; the shards equal the one-process mesh
    of the same grid on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    outs = run_workers("pipeline", 2, tmp_path, timeout=300,
                       env_extra={"CUDA_VISIBLE_DEVICES": os.environ.get(
                           "CUDA_VISIBLE_DEVICES", "0").split(",")[0]},
                       args=("cuda:0",))
    assert all('"data": "gloo"' in out for out in outs)
    check_against_one_process([np.load(tmp_path / f"p{pid}.npz") for pid in range(2)],
                              one_process_reference(2, "cuda:0"))


if __name__ == "__main__":
    role, coordinator, n, pid, out_dir, *rest = sys.argv[1:]
    sys.path.insert(0, str(ROOT))
    ROLES[role](coordinator, int(n), int(pid), out_dir, *rest)
