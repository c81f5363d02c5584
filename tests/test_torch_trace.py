"""The port's spans (``utils/profiler.span``), on the CPU.

A span is recorded only while a ``torch.profiler`` session runs on the calling
thread; it carries its parent and its thread, stands in the Chrome trace as a ``record_function`` event on the same clock, and costs
the program nothing it computes: ``find_pval`` gives the same bits traced or
not.
"""

import json
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from seekr_tpu_torch.io.fasta import write_fasta
from seekr_tpu_torch.models.counter import KmerCounter
from seekr_tpu_torch.models.pearson import pearson
from seekr_tpu_torch.stats import find_pval
from seekr_tpu_torch.utils import profiler, stage_timer, trace_session
from seekr_tpu_torch.utils import logging as seekr_logging
from seekr_tpu_torch.utils.profiler import recorded_spans, reset_spans, span

K = 3


@pytest.fixture(autouse=True)
def empty_buffer():
    reset_spans()
    yield
    reset_spans()


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def by_name(spans):
    return {s["name"]: s for s in spans}


def test_without_a_profiler_nothing_is_recorded():
    with span("outer") as outer:
        with span("inner") as inner:
            pass
    assert outer is inner
    assert recorded_spans() == []


def test_nested_spans_carry_their_parent():
    with cpu_profile():
        with span("outer"):
            with span("inner"):
                with span("leaf"):
                    pass
        with span("next"):
            pass
    got = by_name(recorded_spans())
    outer, inner, leaf, nxt = (got[n] for n in ("outer", "inner", "leaf", "next"))
    assert outer["parent"] is None and nxt["parent"] is None
    assert inner["parent"] == outer["id"] and leaf["parent"] == inner["id"]
    assert len({s["id"] for s in got.values()}) == 4
    assert set(outer) == {"name", "t0", "t1", "id", "parent", "thread"}
    assert outer["t0"] <= inner["t0"] <= leaf["t0"] <= leaf["t1"] <= inner["t1"] <= outer["t1"]
    assert len({s["thread"] for s in got.values()}) == 1


def test_a_second_threads_spans_take_no_parent_of_the_first(monkeypatch):
    # torch keeps one profiler session a process and its probe sees the thread
    # that started it: a probe that answers yes on every thread stands in for
    # sessions on both
    monkeypatch.setattr(profiler, "_probe", lambda: True)
    opened, done = threading.Event(), threading.Event()

    def worker():
        assert opened.wait(30)
        with span("worker"):
            with span("worker.child"):
                pass
        done.set()

    thread = threading.Thread(target=worker)
    thread.start()
    with span("main"):
        opened.set()
        assert done.wait(30)
        with span("main.child"):
            pass
    thread.join(30)
    assert not thread.is_alive()
    got = by_name(recorded_spans())
    main, worker_span = got["main"], got["worker"]
    assert worker_span["parent"] is None
    assert got["worker.child"]["parent"] == worker_span["id"]
    assert got["main.child"]["parent"] == main["id"]
    assert worker_span["thread"] != main["thread"]


def test_the_buffer_stops_at_its_bound_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiler, "MAX_SPANS", 5)
    with cpu_profile():
        for i in range(8):
            with span(f"s{i}"):
                pass
    kept = recorded_spans()
    assert [s["name"] for s in kept] == ["s0", "s1", "s2", "s3", "s4"]
    assert profiler.dropped_spans() == 3
    reset_spans()
    assert recorded_spans() == [] and profiler.dropped_spans() == 0


def test_a_span_agrees_with_its_trace_event_on_the_trace_clock(tmp_path):
    """The span's ``perf_counter`` start and length against its
    ``record_function`` event, placed on ``perf_counter`` through a mark
    recorded just after a reading of the clock, as the benchmark places
    device events."""
    with trace_session(str(tmp_path)) as path:
        t_mark = time.perf_counter()
        with torch.profiler.record_function("mark"):
            pass
        with span("timed"):
            time.sleep(0.02)
    events = json.loads(Path(path).read_text())["traceEvents"]
    mark = next(e for e in events if e.get("name") == "mark")
    event = next(e for e in events if e.get("name") == "timed" and e.get("ph") == "X")
    got = by_name(recorded_spans())["timed"]
    start = t_mark + (float(event["ts"]) - float(mark["ts"])) * 1e-6
    assert abs(start - got["t0"]) < 5e-4
    assert abs(float(event["dur"]) * 1e-6 - (got["t1"] - got["t0"])) < 5e-4
    assert got["t1"] - got["t0"] >= 0.02


def _fasta(path, m, seed):
    rng = np.random.default_rng(seed)
    seqs = ["".join(rng.choice(list("ACGT"), size=int(rng.integers(150, 600))))
            for _ in range(m)]
    write_fasta(str(path), [f"s{seed}_{i}" for i in range(m)], seqs)
    return str(path)


def test_find_pval_traced_gives_its_stages_and_the_same_bits(tmp_path):
    bkg, query = _fasta(tmp_path / "bkg.fa", 40, 1), _fasta(tmp_path / "q.fa", 6, 2)
    counter = KmerCounter(bkg, k=K, silent=True, device="cpu")
    counts = counter.get_counts()
    mean, std = str(tmp_path / "mean.npy"), str(tmp_path / "std.npy")
    np.save(mean, counter.mean)
    np.save(std, counter.std)
    null = pearson(counts, counts, device="cpu")[np.triu_indices(40, 1)]

    plain = find_pval(query, bkg, mean, std, K, null, progress_bar=False, device="cpu")
    assert recorded_spans() == []
    with cpu_profile():
        traced = find_pval(query, bkg, mean, std, K, null, progress_bar=False, device="cpu")
    assert np.array_equal(traced.values, plain.values)

    spans = recorded_spans()
    root = next(s for s in spans if s["name"] == "find_pval")
    assert root["parent"] is None
    children = [s for s in spans if s["parent"] == root["id"]]
    assert sorted(s["name"] for s in children) == [
        "counter.count", "counter.count", "ecdf.search", "ecdf.sort",
        "fasta.read", "fasta.read", "pearson"]
    counts_ids = {s["id"] for s in children if s["name"] == "counter.count"}
    encodes = [s for s in spans if s["name"] == "fasta.encode"]
    assert len(encodes) == 2 and {s["parent"] for s in encodes} == counts_ids
    assert len(spans) == 1 + len(children) + len(encodes)  # nothing else was recorded
    for s in spans:
        assert root["t0"] <= s["t0"] <= s["t1"] <= root["t1"]


def test_stage_timer_is_a_span_and_waits_for_the_card_only_when_logged(monkeypatch,
                                                                        caplog):
    waits = []
    monkeypatch.setattr(seekr_logging, "_sync_card", lambda: waits.append(1))
    seekr_logging.get_logger()
    with cpu_profile():
        with stage_timer("unit/stage", items=4, unit="rows"):
            pass
    assert waits == []
    (got,) = recorded_spans()
    assert got["name"] == "unit/stage"
    caplog.set_level("INFO", logger=seekr_logging.TIMING)
    with stage_timer("unit/logged"):
        pass
    assert waits == [1]
    assert [r.args[0] for r in caplog.records] == ["unit/logged"]
