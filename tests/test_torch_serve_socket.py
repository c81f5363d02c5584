"""The port's socket server, client and serve/query commands against
seekr_tpu's, on the CPU.

* Protocol: the same requests give responses with the same keys; where the
  two services hold the same numbers the responses are equal dicts, and
  otherwise the numbers agree to rtol 1e-5 / atol 1e-5 (the port's Pearson
  tolerance).  Error paths, the line cap and the artifact policy behave as
  seekr_tpu's (tests/test_serve_security.py).
* CLI: ``query`` writes the bytes seekr_tpu's ``query`` writes from the same
  service; ``serve`` answers as the service does, on one device or a mesh
  (``-dp``); the multi-host flags are refused.

Every wait is bounded: each server runs in a thread that is shut down in a
``finally`` and joined with a timeout, and ``request`` always has a timeout.
"""

import contextlib
import io
import json
import os
import socket
import stat
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from seekr_tpu import cli as jax_cli
from seekr_tpu import serve as jax_serve
from seekr_tpu_torch import cli, serve
from seekr_tpu_torch.serve import request

ROOT = Path(__file__).resolve().parents[1]
K = 3
DIGIT2CHAR = np.array(list("AGTC"))
FITRES = [("norm", 0.01, (0.0, 0.25))]
TIMEOUT = 30
SIM_TOL = dict(rtol=1e-5, atol=1e-5)


def seqs_of(rng, n, lo=60, hi=200):
    return ["".join(DIGIT2CHAR[rng.integers(0, 4, size=int(rng.integers(lo, hi)))])
            for _ in range(n)]


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_serve_socket")
    rng = np.random.default_rng(0)
    np.save(tmp / "mean.npy", rng.uniform(0.5, 2.0, 4 ** K))
    np.save(tmp / "std.npy", rng.uniform(0.5, 2.0, 4 ** K))
    (tmp / "targets.fa").write_text(
        "".join(f">t{i}\n{s}\n" for i, s in enumerate(seqs_of(rng, 6))))
    (tmp / "queries.fa").write_text(
        "".join(f">q{i}\n{s}\n" for i, s in enumerate(seqs_of(rng, 3))))
    (tmp / "fitres.csv").write_text('distribution,D,params\nnorm,0.01,"(0.0, 0.25)"\n')
    return tmp


def port_service(tmp, **kw):
    kw.setdefault("targets", str(tmp / "targets.fa"))
    return serve.SeekrService(str(tmp / "mean.npy"), str(tmp / "std.npy"), k=K,
                              device="cpu", **kw)


def jax_service(tmp, **kw):
    kw.setdefault("targets", str(tmp / "targets.fa"))
    return jax_serve.SeekrService(str(tmp / "mean.npy"), str(tmp / "std.npy"), k=K, **kw)


def wait_for_socket(path, thread):
    t0 = time.monotonic()
    while not os.path.exists(path):
        assert thread.is_alive(), "the server thread died before binding"
        assert time.monotonic() - t0 < TIMEOUT, "the server never bound its socket"
        time.sleep(0.02)


def stop(path, thread):
    try:
        request(path, {"op": "shutdown"}, timeout=TIMEOUT)
    except OSError:
        pass
    thread.join(timeout=TIMEOUT)
    assert not thread.is_alive(), "the server thread did not stop"


@contextlib.contextmanager
def running(module, svc, path, artifact_dir=None):
    """``module.serve_forever`` in a thread; shut down and joined on exit."""
    ready = threading.Event()
    thread = threading.Thread(target=module.serve_forever, args=(svc, str(path), ready),
                              kwargs={"artifact_dir": artifact_dir}, daemon=True)
    thread.start()
    try:
        assert ready.wait(TIMEOUT)
        yield str(path)
    finally:
        stop(str(path), thread)


def raw_exchange(path, data: bytes, n_lines: int):
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(TIMEOUT)
        s.connect(path)
        s.sendall(data)
        buf = b""
        while buf.count(b"\n") < n_lines:
            chunk = s.recv(1 << 20)
            if not chunk:
                break
            buf += chunk
    return [json.loads(line) for line in buf.decode().splitlines()]


# -- protocol ------------------------------------------------------------------

def test_round_trip_matches_seekr_tpu(artifacts, tmp_path):
    rng = np.random.default_rng(6)
    queries = seqs_of(rng, 2)
    requests = [{"op": "ping"},
                {"seqs": queries, "want": ["sim", "pvals"], "names": True},
                {"seqs": queries, "want": ["topk", "topk_pvals"], "topk": 2},
                {"seqs": [], "want": ["sim"]},
                {"op": "nope"}]
    answers = {}
    for name, module, svc in (("port", serve, port_service(artifacts, fitres=FITRES)),
                              ("jax", jax_serve, jax_service(artifacts, fitres=FITRES))):
        with running(module, svc, tmp_path / f"{name}.sock") as path:
            answers[name] = [request(path, r, timeout=TIMEOUT) for r in requests]
            answers[name].append(request(path, {"op": "ping"}, timeout=TIMEOUT))
    for got, want in zip(answers["port"], answers["jax"]):
        assert sorted(got) == sorted(want)
        for key, value in want.items():
            if key in ("sim", "pvals", "topk_sim", "topk_pvals"):
                np.testing.assert_allclose(got[key], value, **SIM_TOL, err_msg=key)
            elif key != "latency":
                assert got[key] == value, key
    assert answers["port"][3]["ok"] is False and "empty" in answers["port"][3]["error"]
    assert answers["port"][3]["error"] == answers["jax"][3]["error"]
    pong = answers["port"][-1]
    assert pong["queries_served"] == 2 == pong["device_batches"]  # the failed one not counted
    assert pong["latency"]["count"] == 2


def test_same_numbers_give_the_same_json(artifacts, tmp_path, monkeypatch):
    # with both services handing the handler one result, the two responses are
    # equal, target names and artifact-free inline matrices included
    rng = np.random.default_rng(7)
    out = {"m": 2, "n": 6,
           "sim": rng.normal(size=(2, 6)).astype(np.float32),
           "topk_sim": rng.normal(size=(2, 3)).astype(np.float32),
           "topk_idx": rng.integers(0, 6, size=(2, 3)).astype(np.int32)}
    answers = []
    for name, module, svc in (("port", serve, port_service(artifacts)),
                              ("jax", jax_serve, jax_service(artifacts))):
        monkeypatch.setattr(svc, "query", lambda *a, **k: dict(out))
        with running(module, svc, tmp_path / f"{name}.sock") as path:
            answers.append(request(path, {"seqs": ["AGTC"], "want": ["sim", "topk"],
                                          "names": True}, timeout=TIMEOUT))
    assert answers[0] == answers[1]
    assert answers[0]["topk_names"] == [[f"t{j}" for j in row] for row in out["topk_idx"]]


def test_socket_created_owner_only(artifacts, tmp_path):
    with running(serve, port_service(artifacts), tmp_path / "s.sock") as path:
        assert stat.S_IMODE(os.stat(path).st_mode) == 0o600
    assert not os.path.exists(tmp_path / "s.sock")  # removed on shutdown


def test_artifact_writes_rejected_by_default(artifacts, tmp_path):
    rng = np.random.default_rng(1)
    with running(serve, port_service(artifacts), tmp_path / "s.sock") as path:
        out = request(path, {"seqs": seqs_of(rng, 1), "want": ["sim"],
                             "outfile": str(tmp_path / "res")}, timeout=TIMEOUT)
        assert not out["ok"] and "--allow-artifacts" in out["error"]
        out = request(path, {"op": "save_corpus", "path": str(tmp_path / "c.npz")},
                      timeout=TIMEOUT)
        assert not out["ok"] and "--allow-artifacts" in out["error"]
    assert not (tmp_path / "res_sim.npy").exists() and not (tmp_path / "c.npz").exists()


def test_artifact_writes_confined_to_allowed_dir(artifacts, tmp_path):
    allowed = tmp_path / "allowed"
    allowed.mkdir()
    evil = tmp_path / "evil"
    evil.mkdir()
    (allowed / "link").symlink_to(evil)
    victim = tmp_path / "victim.bin"
    victim.write_bytes(b"precious")
    (allowed / "planted_sim.npy").symlink_to(victim)
    rng = np.random.default_rng(2)
    svc = port_service(artifacts)
    with running(serve, svc, tmp_path / "s.sock", artifact_dir=str(allowed)) as path:
        def ask(payload):
            return request(path, payload, timeout=TIMEOUT)

        for outfile in ("/etc/cron.d/x", str(allowed / ".." / "esc"),
                        str(allowed / "link" / "res"), str(allowed),
                        str(allowed / "planted")):
            out = ask({"seqs": seqs_of(rng, 1), "want": ["sim"], "outfile": outfile})
            assert not out["ok"] and "outside" in out["error"], outfile
        queries = seqs_of(rng, 2)
        out = ask({"seqs": queries, "want": ["sim"], "outfile": str(allowed / "res")})
        assert out["ok"] and "sim" not in out
        assert out["files"]["sim"] == str(allowed / "res_sim.npy")
        np.testing.assert_array_equal(np.load(out["files"]["sim"]), svc.query(queries)["sim"])
        assert ask({"op": "save_corpus", "path": str(allowed / "c.npz")})["ok"]
        out = ask({"op": "save_corpus", "path": str(tmp_path / "outside.npz")})
        assert not out["ok"] and "outside" in out["error"]
    assert (allowed / "c.npz").exists() and not (tmp_path / "outside.npz").exists()
    assert not list(evil.iterdir()) and not (tmp_path / "esc_sim.npy").exists()
    assert victim.read_bytes() == b"precious"


def test_oversize_line_rejected_without_desync(artifacts, tmp_path, monkeypatch):
    monkeypatch.setattr(serve, "_MAX_REQUEST", 4096)
    with running(serve, port_service(artifacts), tmp_path / "s.sock") as path:
        big = json.dumps({"seqs": ["A" * 8192], "want": ["sim"]}).encode()
        first, second = raw_exchange(path, big + b"\n" + b'{"op": "ping"}\n', 2)
    assert not first["ok"] and "exceeds" in first["error"]
    assert second["ok"] and second["k"] == K


def test_malformed_requests_answer_errors(artifacts, tmp_path):
    garbage = [b"not json at all", b"\x00\xff\xfe\x80 binary noise", b'{"seqs": ',
               b"[1, 2, 3]", b"{}", b'{"seqs": 5}', b'{"seqs": []}', b'{"seqs": [42]}',
               b'{"seqs": ["AGTC"], "want": ["bogus"]}', b'{"seqs": ["AGTC"], "topk": "x"}',
               b'{"op": []}', b'{"op": "nope"}', b'{"op": "add_targets"}',
               b'{"op": "save_corpus"}',
               json.dumps({"seqs": ["AGTC"], "want": ["sim"], "outfile": 123}).encode()]
    rng = np.random.default_rng(3)
    with running(serve, port_service(artifacts), tmp_path / "s.sock") as path:
        for line in garbage:
            (resp,) = raw_exchange(path, line + b"\n", 1)
            assert resp["ok"] is False and resp["error"], (line, resp)
        out = request(path, {"seqs": seqs_of(rng, 2), "want": ["sim"]}, timeout=TIMEOUT)
        assert out["ok"] and len(out["sim"]) == 2


def test_add_targets_and_save_corpus_over_the_socket(artifacts, tmp_path):
    rng = np.random.default_rng(35)
    fa = tmp_path / "extra.fa"
    fa.write_text(">e0\n" + seqs_of(rng, 1)[0] + "\n")
    svc = port_service(artifacts)
    with running(serve, svc, tmp_path / "s.sock", artifact_dir=str(tmp_path)) as path:
        assert request(path, {"op": "add_targets", "fasta": str(fa)},
                       timeout=TIMEOUT) == {"ok": True, "n": 7, "added": 1}
        assert request(path, {"op": "add_targets", "seqs": seqs_of(rng, 2),
                              "names": ["x0", "x1"]}, timeout=TIMEOUT)["n"] == 9
        out = request(path, {"seqs": seqs_of(rng, 1), "want": ["topk"], "topk": 9},
                      timeout=TIMEOUT)
        assert out["ok"] and out["n"] == 9
        assert sorted(out["topk_names"][0]) == sorted(svc.target_names)
        snap = str(tmp_path / "c.npz")
        assert request(path, {"op": "save_corpus", "path": snap}, timeout=TIMEOUT) == \
            {"ok": True, "path": snap}
    assert jax_service(artifacts, targets=snap).target_names == svc.target_names


def test_request_imports_no_torch(tmp_path):
    """The client, and the socket layer under it, import no torch: a client
    process never touches a card."""
    code = f"""
import sys, threading
sys.path.insert(0, {str(ROOT)!r})
from seekr_tpu_torch import serve

class Stub:
    k, log2, target_names, fitres, queries_served, device_batches = 3, "Log2.post", ["t0"], None, 0, 0
    def latency_stats(self):
        return {{"count": 0}}
    def stop_followers(self):
        pass

ready = threading.Event()
t = threading.Thread(target=serve.serve_forever, args=(Stub(), "s.sock", ready), daemon=True)
t.start()
assert ready.wait(30)
pong = serve.request("s.sock", {{"op": "ping"}}, timeout=30)
assert pong["ok"] and pong["targets"] == 1, pong
assert serve.request("s.sock", {{"op": "shutdown"}}, timeout=30)["ok"]
t.join(30)
assert not t.is_alive()
bad = [m for m in sys.modules if m.split(".")[0] == "torch"]
assert not bad, bad[:5]
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# -- serve / query commands ----------------------------------------------------

@pytest.fixture(scope="module")
def cli_server(artifacts, tmp_path_factory):
    """``serve`` of the port's command line in a thread, with a fitres."""
    path = str(tmp_path_factory.mktemp("cli_server") / "s.sock")
    argv = ["serve", str(artifacts / "mean.npy"), str(artifacts / "std.npy"), "-k", str(K),
            "-t", str(artifacts / "targets.fa"), "-fr", str(artifacts / "fitres.csv"),
            "--socket", path, "--device", "cpu", "--no-warmup"]
    thread = threading.Thread(target=cli.main, args=(argv,), daemon=True)
    thread.start()
    try:
        wait_for_socket(path, thread)
        yield path
    finally:
        stop(path, thread)


def run_query(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(["query"] + argv)
    return out.getvalue()


@pytest.mark.parametrize("flags", [[], ["--pvals"], ["--topk", "2"], ["--topk", "2", "--pvals"],
                                   ["--topk", "10"]],
                         ids=["sim", "sim-pvals", "topk", "topk-pvals", "topk-clamped"])
@pytest.mark.parametrize("to_file", [False, True], ids=["stdout", "file"])
def test_query_bytes_equal_seekr_tpu(artifacts, cli_server, tmp_path, flags, to_file):
    results = {}
    for name, main in (("port", cli.main), ("jax", jax_cli.main)):
        argv = [str(artifacts / "queries.fa"), "--socket", cli_server, "--timeout",
                str(TIMEOUT)] + flags
        if to_file:
            stem = tmp_path / name
            printed = run_query(main, argv + ["-o", f"{stem}.csv"])
            files = sorted(tmp_path.glob(f"{name}*.csv"))
            results[name] = (printed, [f.name[len(name):] for f in files],
                             [f.read_bytes() for f in files])
        else:
            results[name] = run_query(main, argv)
    assert results["port"] == results["jax"]
    if not to_file:
        assert results["port"].count("\n") > 3


def test_query_answers_as_the_service(artifacts, cli_server, tmp_path):
    from seekr_tpu_torch.io.fast_csv import read_labeled_csv
    from seekr_tpu_torch.io.fasta import Reader

    cli.main(["query", str(artifacts / "queries.fa"), "--socket", cli_server,
              "-o", str(tmp_path / "sim.csv")])
    got = read_labeled_csv(tmp_path / "sim.csv")
    assert got.index == ["q0", "q1", "q2"] and got.columns == [f"t{i}" for i in range(6)]
    want = port_service(artifacts).query(Reader(str(artifacts / "queries.fa")).get_seqs())
    np.testing.assert_array_equal(got.values.astype(np.float32), want["sim"])


def test_query_reports_a_service_error(artifacts, cli_server, capsys):
    # the CLI server allows no artifact writes, so --npy is refused
    with pytest.raises(SystemExit) as exc:
        cli.main(["query", str(artifacts / "queries.fa"), "--socket", cli_server,
                  "--npy", "/nonexistent/prefix"])
    assert exc.value.code == 1
    assert "--allow-artifacts" in capsys.readouterr().err


def test_serve_save_corpus_loads_in_seekr_tpu(artifacts, tmp_path):
    snap = str(tmp_path / "c.npz")
    cli.main(["serve", str(artifacts / "mean.npy"), str(artifacts / "std.npy"), "-k", str(K),
              "-t", str(artifacts / "targets.fa"), "--save-corpus", snap, "--device", "cpu"])
    queries = seqs_of(np.random.default_rng(4), 2)
    np.testing.assert_array_equal(port_service(artifacts).query(queries)["sim"],
                                  port_service(artifacts, targets=snap).query(queries)["sim"])
    np.testing.assert_allclose(jax_service(artifacts, targets=snap).query(queries)["sim"],
                               jax_service(artifacts).query(queries)["sim"], **SIM_TOL)


@pytest.mark.parametrize("flags,message", [
    (["-dp", "2"], "-dp requires -t/--targets"),
    # seekr_tpu's checks of a pod (cli.py:535-555), made before any rendezvous
    (["--num_processes", "2"], "--num_processes > 1 requires -dp N covering all devices"),
    (["--num_processes", "2", "-dp", "2"], "-dp requires -t/--targets"),
    (["--save-corpus", "c.npz"], "requires -t/--targets"),
])
def test_serve_refusals(artifacts, capsys, flags, message):
    with pytest.raises(SystemExit) as exc:
        cli.main(["serve", str(artifacts / "mean.npy"), str(artifacts / "std.npy"),
                  "--device", "cpu"] + flags)
    assert exc.value.code == 2 and message in capsys.readouterr().err


def test_serve_on_a_mesh_saves_the_same_corpus(artifacts, tmp_path):
    snaps = [str(tmp_path / f"{name}.npz") for name in ("one", "mesh")]
    for snap, flags in zip(snaps, ([], ["-dp", "4"])):
        cli.main(["serve", str(artifacts / "mean.npy"), str(artifacts / "std.npy"),
                  "-k", str(K), "-t", str(artifacts / "targets.fa"), "--save-corpus", snap,
                  "--device", "cpu"] + flags)
    with np.load(snaps[0]) as one, np.load(snaps[1]) as mesh:
        assert one.files == mesh.files
        for key in one.files:
            np.testing.assert_array_equal(one[key], mesh[key])


def test_serve_needs_a_card_unless_cpu_is_asked(artifacts, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["serve", str(artifacts / "mean.npy"), str(artifacts / "std.npy"),
                  "-k", str(K), "--socket", "unused.sock"])


def test_serve_and_query_flags_cover_seekr_tpu(monkeypatch):
    class Parsed(Exception):
        pass

    def grab(parser, argv=None):
        raise Parsed(parser)

    def flags(parser):
        return {o for a in parser._actions for o in a.option_strings}

    monkeypatch.setattr(cli, "_parse_args_or_exit", grab)
    for command in ("serve", "query"):
        theirs = flags(jax_cli._collect_parser(getattr(jax_cli, f"console_{command}")))
        with pytest.raises(Parsed) as exc:
            cli.COMMANDS[command]([])
        ours = flags(exc.value.args[0])
        assert theirs <= ours, theirs - ours
        assert ("--device" in ours) == (command == "serve")
