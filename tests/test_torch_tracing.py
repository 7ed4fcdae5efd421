"""The port's span and counter recorder (``utils/profiling.py``) on the
CPU: nothing is kept while recording is off; spans nest by parent and
thread, and the work of the charge and block threads, and the exact
backend's scoring and linking, lead up to the pass's ``run`` root; the
accumulators sum what they time; the export's phases nest in ``export``
and its counters count its rows, groups and masked shards; dbscan mode's
counters are counted inside their phases and charges, and linkage mode
counts none of them; the phase
summary is the same with and without recording; a phase is a
``torch.profiler`` range of ``--profile``'s trace; and the CLI writes the
same CSV bytes with recording on and off."""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

import falcon_tpu_torch.store.store as t_store
from falcon_tpu_torch import cli, ingest
from falcon_tpu_torch.cluster.grouped import score_and_link
from falcon_tpu_torch.device import DEVICE_ENV
from falcon_tpu_torch.export import export_cluster_csv
from falcon_tpu_torch.ops import pairwise
from falcon_tpu_torch.simulate import make_clustered_spectra, write_mgf
from falcon_tpu_torch.utils.profiling import (PhaseProfiler,
                                              TorchPhaseProfiler, profiler)
from torch_cases import EXPORT_TIE_CHARGES, export_tie_store

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
    with p.phase("a"), p.span("b"), p.gauge("g"):
        p.count("c", 3)
        p.add("d", 0.5)
    assert p.spans() == [] and p.counters() == {}
    assert p.summary().keys() == {"a", "d"}

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
    ([], {}, None),
], ids=["charge_threads", "block_threads", "exact_backend"])
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
    if thread_phase is None:
        # The exact backend scores and links each charge on the charge's
        # own thread: K4's launches and the stage's two sums lead up to
        # the charge, then to the run.
        for name in ("score groups (K4)", "wait for scores",
                     "linkage and refinement"):
            found = [s for s in spans if s.name == name]
            assert found, f"no {name!r} span"
            for s in found:
                chain = _chain(spans, s)
                assert chain[1].startswith("cluster charge ")
                assert chain[2:] == ["run"]
                assert s.thread == run.thread
        return
    workers = [s for s in spans
               if s.name == thread_phase and s.thread != run.thread]
    assert workers, f"no {thread_phase!r} span off the main thread"
    for s in workers:
        assert _chain(spans, s)[-1] == "run"


def test_accumulators_sum_what_they_time():
    # The score-and-link stage's accumulators split the seconds it
    # returns: waiting (here on a large group's scorer, 10 ms a group) and
    # linking.  A sum given to ``add`` is a span that ends when it is
    # added.
    spectra, _ = make_clustered_spectra(n_clusters=4, cluster_size=5,
                                        n_noise=0, seed=7, charges=(2,))
    offsets = np.concatenate([[0], np.cumsum([len(s.mz) for s in spectra])])
    mz_flat = np.concatenate([s.mz for s in spectra]).astype(np.float32)
    int_flat = np.concatenate([s.intensity for s in spectra]).astype(
        np.float32)
    group_off = np.cumsum([0, 2, 5, 3, 6, 4])
    rows = np.arange(group_off[-1])
    mzs = np.asarray([s.precursor_mz for s in spectra])[rows]

    def slow(mz, intensity, device):
        time.sleep(0.01)
        return pairwise.condensed_distances(mz, intensity, 0.05,
                                            device=device)

    profiler.start_recording()
    t0 = time.perf_counter_ns()
    try:
        linked = score_and_link(
            offsets, mz_flat, int_flat, 64, rows, group_off, mzs, None,
            "complete", 0.1, 20.0, "ppm", None, 0, 0.05, 4, slow,
            torch.device("cpu"), counters="t")
    finally:
        profiler.stop_recording()
    outside = time.perf_counter_ns() - t0
    counters = profiler.counters()
    assert counters["t.components"] == 5
    assert counters["t.batches"] == 3  # one K4 launch, two large groups
    assert 2 * 10**7 <= counters["t.wait_ns"] <= outside
    assert abs(counters["t.wait_ns"] - linked.wait_s * 1e9) < 10**3
    linking = counters["t.native_ns"] + counters["t.refine_ns"]
    assert abs(linking - linked.link_s * 1e9) < 10**3
    assert counters["t.wait_ns"] + linking <= outside

    p = PhaseProfiler()
    p.start_recording()
    with p.span("outer"):
        p.add("waited", 0.25)
    p.stop_recording()
    waited, outer = p.spans()
    assert waited.name == "waited" and waited.parent == outer.id
    assert abs(waited.end_ns - waited.start_ns - 25 * 10**7) < 10**6
    assert p.summary() == {"waited": 0.25}


def test_counters_and_gauges_lose_no_update_across_threads():
    p = PhaseProfiler()
    p.start_recording()
    n_threads, n_each = 16, 500
    start = threading.Barrier(n_threads)

    def work():
        start.wait(timeout=30)
        for _ in range(n_each):
            with p.gauge("g"):
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


def test_export_nests_its_phases_and_counts_its_rows(corpus):
    """A one-file CLI run: the export's shard loads, sort and row
    formatting are phases inside ``export``, and the recorder counts one
    tie group, every CSV row and no masked shard."""
    tmp_path, mgf = corpus
    csv = _run_cli(tmp_path, mgf, ANN, record=True)
    counters = profiler.counters()
    rows = [line for line in csv.splitlines()
            if not line.startswith(b"#")][1:]
    assert counters["export.rows"] == len(rows) > 0
    assert counters["export.groups"] == 1
    assert counters["export.masked_shards"] == 0
    spans = profiler.spans()
    (whole,) = [s for s in spans if s.name == "export"]
    for name in ("export: load", "export: sort", "export: format"):
        inner = [s for s in spans if s.name == name]
        assert inner
        for span in inner:
            assert span.parent == whole.id
            assert (whole.start_ns <= span.start_ns <= span.end_ns
                    <= whole.end_ns)


def test_export_counts_the_shards_it_masks(tmp_path):
    """Shards that each hold rows of several files take the masked path,
    and the recorder counts them."""
    store, labels = export_tie_store(str(tmp_path / "store"), t_store)
    entries = [(store.dataset(c), lab)
               for c, lab in zip(EXPORT_TIE_CHARGES, labels)]
    profiler.start_recording()
    try:
        n = export_cluster_csv(str(tmp_path / "out.csv"), lambda f: None,
                               entries)
    finally:
        profiler.stop_recording()
    counters = profiler.counters()
    several = sum(len(set(np.load(os.path.join(s, "filename.npy")))) > 1
                  for ds, _ in entries for s in ds.shards)
    assert counters["export.masked_shards"] == several > 0
    assert counters["export.groups"] == 2  # b,2 and the three tied names
    assert counters["export.rows"] == n == sum(len(lab) for lab in labels)


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


DBSCAN_COUNTERS = {
    "ann.dbscan.rounds": "ann: dbscan", "ann.dbscan.core": "ann: dbscan",
    "ann.refine.clusters": "ann: refine", "ann.refine.split": "ann: refine",
    "ann.refine.demoted": "ann: refine", "ann.medoids.listed": "ann: medoids"}


def test_dbscan_counters_are_counted_inside_their_charge(corpus,
                                                         monkeypatch):
    """Each of dbscan mode's counters is counted inside its phase, on the
    way up to its charge's span and the run; each charge counts them; and
    linkage mode counts none of them.  The charges run in turn, each in
    its ``cluster charge N`` phase (two at once, each runs on a pool thread
    under the run while the phase waits for it)."""
    tmp_path, mgf = corpus
    monkeypatch.setenv("FALCON_TPU_NO_CHARGE_OVERLAP", "1")
    real = profiler.count

    def count(name, n=1):
        # A recorder span marks where the count was taken.
        with profiler.span(f"count {name}"):
            real(name, n)
    monkeypatch.setattr(profiler, "count", count)
    _run_cli(tmp_path, mgf, ANN + ["--cluster_method", "dbscan"],
             record=True)
    spans = profiler.spans()
    counters = profiler.counters()
    assert set(DBSCAN_COUNTERS) <= set(counters)
    assert counters["ann.dbscan.rounds"] > 0
    assert counters["ann.refine.clusters"] > 0
    charges = {s.name for s in spans if s.name.startswith("cluster charge ")}
    assert len(charges) == 2
    for name, phase in DBSCAN_COUNTERS.items():
        seen = set()
        for s in spans:
            if s.name != f"count {name}":
                continue
            chain = _chain(spans, s)
            assert chain[1] == phase, (name, chain)
            assert chain[-1] == "run"
            (charge,) = [c for c in chain if c.startswith("cluster charge ")]
            seen.add(charge)
        assert seen == charges, name

    _run_cli(tmp_path, mgf, ANN, record=True)
    counters = profiler.counters()
    assert counters["ann.linkage.components"] > 0
    assert not set(DBSCAN_COUNTERS) & set(counters)


@pytest.mark.parametrize("flags", [ANN, []], ids=["ann_linkage", "exact"])
def test_csv_bytes_are_the_same_with_recording_on_and_off(corpus, flags):
    tmp_path, mgf = corpus
    off = _run_cli(tmp_path, mgf, flags, record=False)
    on = _run_cli(tmp_path, mgf, flags, record=True)
    assert on == off
    counters = profiler.counters()
    prefix = "ann.linkage" if flags else "exact.linkage"
    assert counters[f"{prefix}.components"] == (
        counters.get(f"{prefix}.whole", 0) + counters[f"{prefix}.linked"])
    assert counters[f"{prefix}.pairs"] > 0
    # The batched native linkage ran: a call per K4 launch and per large
    # group.
    assert 0 < counters[f"{prefix}.batches"] <= (
        counters[f"{prefix}.components"])
    for name in ("wait_ns", "native_ns", "refine_ns"):
        assert counters[f"{prefix}.{name}"] > 0
    if flags:
        assert counters["ann.linkage.whole"] > 0
        linkage = sum(s.end_ns - s.start_ns for s in profiler.spans()
                      if s.name == "ann: linkage")
        parts = sum(counters[f"ann.linkage.{name}"]
                    for name in ("wait_ns", "native_ns", "refine_ns"))
        assert parts <= linkage
    else:
        assert not any(name.startswith("ann.linkage.") for name in counters)
