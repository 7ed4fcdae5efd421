"""The port's span and counter recorder (``utils/profiling.py``) on the
CPU: nothing is kept while recording is off; spans nest by parent and
thread, and the work of the charge, block and producer threads leads up
to the pass's ``run`` root; the accumulators sum what they time; the phase
summary is the same with and without recording; a phase is a
``torch.profiler`` range of ``--profile``'s trace; and the CLI writes the
same CSV bytes with recording on and off."""

import json
import os
import sys
import threading
import time

import pytest
import torch

from falcon_tpu_torch import cli, ingest
from falcon_tpu_torch.device import DEVICE_ENV
from falcon_tpu_torch.simulate import make_clustered_spectra, write_mgf
from falcon_tpu_torch.utils.profiling import (PhaseProfiler,
                                              TorchPhaseProfiler, profiler)

ANN = ["--backend", "ann"]


@pytest.fixture()
def corpus(tmp_path, monkeypatch):
    """Two charges of clusters up to 12 spectra; components of more than
    4 spectra take the large-component route."""
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    monkeypatch.setenv("FALCON_TPU_LINKAGE_GROUP_MAX", "4")
    spectra, _ = make_clustered_spectra(
        n_clusters=16, cluster_size=12, n_noise=20, seed=5, charges=(2, 3),
        precursor_classes=6)
    return tmp_path, write_mgf(str(tmp_path / "in.mgf"), spectra)


def _run_cli(tmp_path, mgf, flags, record, name="out"):
    """One CLI call (recording on or off); its CSV bytes."""
    args = [mgf, str(tmp_path / name), "--work_dir", str(tmp_path / "work"),
            "--overwrite", *flags]
    if record:
        profiler.start_recording()
    try:
        assert cli.main(args) == 0
    finally:
        profiler.stop_recording()
    return (tmp_path / f"{name}.csv").read_bytes()


def _chain(spans, span):
    """Names from ``span`` up to its root."""
    by_id = {s.id: s for s in spans}
    names = [span.name]
    while span.parent is not None:
        span = by_id[span.parent]
        names.append(span.name)
    return names


def test_recording_off_keeps_nothing(corpus):
    tmp_path, mgf = corpus
    p = PhaseProfiler()
    with p.phase("a"), p.span("b"), p.timer("t"), p.gauge("g"):
        p.count("c", 3)
        list(p.timed("w", range(3)))
    assert p.spans() == [] and p.counters() == {}
    assert p.summary().keys() == {"a"}

    profiler.start_recording()
    profiler.stop_recording()
    _run_cli(tmp_path, mgf, ANN, record=False)
    assert profiler.spans() == []
    assert all(v == 0 for v in profiler.counters().values())


def test_spans_nest_by_parent_and_thread():
    p = PhaseProfiler()
    p.start_recording()
    seen = {}

    def work():
        seen["thread"] = threading.get_ident()
        with p.phase("child"):
            pass

    with p.span("run", root=True):
        with p.phase("outer"):
            with p.span("inner"):
                pass
            t = threading.Thread(target=p.bind(work))
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
        with p.span("again", root=True):
            pass
    p.stop_recording()
    spans = {s.name: s for s in p.spans()}
    me = threading.get_ident()
    assert spans["run"].parent is None and spans["run"].root == spans["run"].id
    assert spans["outer"].parent == spans["run"].id
    assert spans["inner"].parent == spans["outer"].id
    assert spans["child"].parent == spans["outer"].id
    assert spans["child"].thread == seen["thread"] != me
    assert {spans[n].thread for n in ("run", "outer", "inner")} == {me}
    assert {s.root for n, s in spans.items() if n != "again"} == {
        spans["run"].id}
    assert spans["again"].parent is None
    assert spans["again"].root == spans["again"].id
    for s in spans.values():
        assert s.start_ns <= s.end_ns
    assert spans["run"].start_ns <= spans["child"].start_ns
    assert spans["child"].end_ns <= spans["run"].end_ns


@pytest.mark.parametrize("flags,env,thread_phase", [
    (ANN, {}, "ann: load"),
    (ANN, {"FALCON_TPU_DEVICE_BLOCK_CAP": "48",
           "FALCON_TPU_BLOCK_PIPELINE": "2"}, "ann: upload"),
    ([], {}, "score groups (K4)"),
], ids=["charge_threads", "block_threads", "exact_producer"])
def test_worker_threads_lead_up_to_the_run_root(corpus, monkeypatch, flags,
                                                env, thread_phase):
    tmp_path, mgf = corpus
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    _run_cli(tmp_path, mgf, flags, record=True)
    spans = profiler.spans()
    runs = [s for s in spans if s.name == "run"]
    assert len(runs) == 1 and runs[0].parent is None
    run = runs[0]
    assert {s.root for s in spans} == {run.id}
    assert all(run.start_ns <= s.start_ns <= s.end_ns <= run.end_ns
               for s in spans)
    workers = [s for s in spans
               if s.name == thread_phase and s.thread != run.thread]
    assert workers, f"no {thread_phase!r} span off the main thread"
    for s in workers:
        assert _chain(spans, s)[-1] == "run"
    if flags == []:
        by_name = {}
        for s in spans:
            by_name.setdefault(s.name, []).append(s)
        for name, charge_thread in (("exact: consume", True),
                                    ("exact: produce", False)):
            for s in by_name[name]:
                parent = next(x for x in spans if x.id == s.parent)
                assert parent.name.startswith("cluster charge ")
                assert (s.thread == parent.thread) == charge_thread
        assert {_chain(spans, s)[1] for s in workers} == {"exact: produce"}


def test_accumulators_sum_what_they_time():
    p = PhaseProfiler()
    p.start_recording()
    t0 = time.perf_counter_ns()
    for _ in range(3):
        with p.timer("t"):
            time.sleep(0.01)
    outside = time.perf_counter_ns() - t0

    def slow():
        for i in range(4):
            time.sleep(0.005)
            yield i

    got = []
    t0 = time.perf_counter_ns()
    for i in p.timed("w", slow()):
        got.append(i)
        time.sleep(0.02)  # the consumer's own time is not counted
    loop = time.perf_counter_ns() - t0
    p.count("c")
    p.count("c", 41)
    p.stop_recording()
    counters = p.counters()
    assert got == [0, 1, 2, 3]
    assert 3 * 10**7 <= counters["t"] <= outside
    assert 2 * 10**7 <= counters["w"] <= loop - 8 * 10**7
    assert counters["c"] == 42
    assert p.spans() == []


def test_counters_and_gauges_lose_no_update_across_threads():
    p = PhaseProfiler()
    p.start_recording()
    n_threads, n_each = 16, 500
    start = threading.Barrier(n_threads)

    def work():
        start.wait(timeout=30)
        for _ in range(n_each):
            with p.gauge("g"), p.timer("t"):
                p.count("c")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    p.stop_recording()
    counters = p.counters()
    assert counters["c"] == n_threads * n_each
    assert 1 <= counters["g.max"] <= n_threads
    # Every level entered was left: a new recording starts from 0.
    p.start_recording()
    assert p.counters() == {"g.max": 0}


def test_summary_is_the_same_with_and_without_recording(corpus):
    tmp_path, mgf = corpus
    summaries = []
    for record in (False, True):
        _run_cli(tmp_path, mgf, ANN, record)
        summaries.append(profiler.summary())
    assert list(summaries[0]) == list(summaries[1])
    assert "run" not in summaries[1]
    for name in ("ann: load", "ann: components", "ann: linkage",
                 "ingest: parse", "ingest: write"):
        assert name in summaries[1]
    # Every phase of the summary was recorded as a span.
    assert set(summaries[1]) <= {s.name for s in profiler.spans()}


@pytest.mark.parametrize("n_ranges", [1, 4])
def test_ingest_counts_its_ranges_and_nests_its_phases(tmp_path, monkeypatch,
                                                       n_ranges):
    """One MGF of spectra over the 50-peak cap, parsed whole or as byte
    ranges: the recorder counts the ranges, the spectra, the top-N cuts,
    the shards and no title decoded in Python, and the parse and the
    writes are phases inside ``ingest``."""
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    spectra, _ = make_clustered_spectra(
        n_clusters=12, cluster_size=6, n_noise=20, n_peaks=(60, 90), seed=9,
        charges=(2, 3), precursor_classes=6)
    mgf = write_mgf(str(tmp_path / "in.mgf"), spectra)
    size = os.path.getsize(mgf)
    monkeypatch.setattr(ingest, "_RANGE_MIN_BYTES", 1)
    monkeypatch.setattr(ingest, "_RANGE_TARGET_BYTES", size // 4)
    monkeypatch.setattr(ingest.multiprocessing, "cpu_count",
                        lambda: n_ranges)
    _run_cli(tmp_path, mgf, [], record=True)
    counters = profiler.counters()
    assert counters["ingest.ranges"] == n_ranges
    assert counters["ingest.spectra"] == len(spectra)
    assert counters["ingest.topn_cut"] > 0
    assert counters["ingest.titles_fallback"] == 0
    assert counters["ingest.shards"] == 2  # one a charge
    spans = profiler.spans()
    (whole,) = [s for s in spans if s.name == "ingest"]
    for name in ("ingest: parse", "ingest: write"):
        (span,) = [s for s in spans if s.name == name]
        assert span.parent == whole.id
        assert whole.start_ns <= span.start_ns <= span.end_ns <= whole.end_ns


def test_a_phase_is_a_profiler_range_that_starts_with_its_span(tmp_path):
    p = TorchPhaseProfiler()
    p.start_recording()
    p.start_trace(str(tmp_path))
    with p.phase("traced phase"):
        torch.ones(8).sum()
    p.stop_trace()
    p.stop_recording()
    (span,) = p.spans()
    trace = json.loads((tmp_path / "trace.json").read_text())
    (event,) = [e for e in trace["traceEvents"]
                if e.get("name") == "traced phase"]
    event_ns = int(event["ts"] * 1000) + trace.get("baseTimeNanoseconds", 0)
    assert abs(event_ns - span.start_ns) < 5 * 10**6


@pytest.mark.parametrize("flags", [ANN, []], ids=["ann_linkage", "exact"])
def test_csv_bytes_are_the_same_with_recording_on_and_off(corpus, flags):
    tmp_path, mgf = corpus
    off = _run_cli(tmp_path, mgf, flags, record=False)
    on = _run_cli(tmp_path, mgf, flags, record=True)
    assert on == off
    counters = profiler.counters()
    if flags:
        assert counters["ann.linkage.components"] == (
            counters.get("ann.linkage.whole", 0)
            + counters["ann.linkage.linked"])
        assert counters["ann.linkage.whole"] > 0
        assert counters["ann.linkage.pairs"] > 0
        # The batched native linkage ran: a call per K4 launch and per
        # large component.
        assert 0 < counters["ann.linkage.batches"] <= (
            counters["ann.linkage.components"])
        for name in ("wait_ns", "native_ns", "refine_ns"):
            assert counters[f"ann.linkage.{name}"] > 0
        linkage = sum(s.end_ns - s.start_ns for s in profiler.spans()
                      if s.name == "ann: linkage")
        parts = sum(counters[f"ann.linkage.{name}"]
                    for name in ("wait_ns", "native_ns", "refine_ns"))
        assert parts <= linkage
    else:
        assert counters["exact.intervals.linked"] > 0
        assert counters["exact.linkage.native_ns"] > 0
