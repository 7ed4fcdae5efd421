"""falcon's published DBSCAN deployment (``--backend ann --cluster_method
dbscan --eps 0.1 --min_samples 2``, the flags of
``portbench/configs/ann-dbscan.json``) through the port's CLI on the CPU:
on two seeded corpora it gives the plain reference's single-linkage labels
(the reading the benchmark cell ``ann-dbscan-262k`` takes), the labels of
a brute-force DBSCAN written here from the textbook definition, and the
JAX package's CSV bytes; at ``min_samples`` 3 the brute-force DBSCAN
departs from single linkage, so the reference's reading rests on
``min_samples`` 2; the recorder holds the DBSCAN tail's counters, and the
CSV bytes are the same with recording on and off."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from falcon_tpu import cli as jax_cli
from falcon_tpu_torch import cli
from falcon_tpu_torch.device import DEVICE_ENV
from falcon_tpu_torch.utils.profiling import profiler
from portbench import generator, reference
from portbench.run import read_csv_labels

REPO = Path(__file__).resolve().parents[1]
DBSCAN = json.loads((REPO / "portbench/configs/ann-dbscan.json").read_text())
FLAGS = DBSCAN["flags"]
SETTINGS = DBSCAN["settings"]
COUNTERS = ("ann.dbscan.rounds", "ann.dbscan.core", "ann.refine.clusters",
            "ann.refine.split", "ann.refine.demoted", "ann.medoids.listed")


def _with_shifted_copies(c: generator.Corpus, rows: np.ndarray,
                         shifts_ppm) -> generator.Corpus:
    """``c`` with a copy of each of ``rows`` appended per shift, its
    precursor m/z moved by that many ppm (new scan numbers): a chain of
    copies that spans more than the tolerance makes a cluster that the
    refinement splits."""
    rows = np.tile(rows, len(shifts_ppm))
    scale = 1 + np.repeat(np.asarray(shifts_ppm, np.float64),
                          len(rows) // len(shifts_ppm)) / 1e6
    idx = np.concatenate([np.arange(c.offsets[r], c.offsets[r + 1])
                          for r in rows])
    lengths = np.diff(c.offsets)[rows]

    def cat(a):
        return np.concatenate([a, a[rows]])

    return generator.Corpus(
        offsets=np.concatenate([c.offsets,
                                c.offsets[-1] + np.cumsum(lengths)]),
        mz=np.concatenate([c.mz, c.mz[idx]]),
        intensity=np.concatenate([c.intensity, c.intensity[idx]]),
        precursor_mz=np.concatenate([c.precursor_mz,
                                     c.precursor_mz[rows] * scale]),
        charge=cat(c.charge), rt=cat(c.rt), truth=cat(c.truth),
        is_noise=cat(c.is_noise), group=cat(c.group), member=cat(c.member),
        scan=np.concatenate([c.scan, len(c) + np.arange(len(rows))]))


def _corpus(tmp, seed, sizes, n_noise, charges, classes):
    c = generator.make_clustered_spectra(
        n_clusters=len(sizes), cluster_size=sizes, n_noise=n_noise,
        charges=charges, precursor_classes=classes, seed=seed)
    # Every 25th spectrum twice more, 5 and 22 ppm higher: the second
    # copy links to the cluster through the first only, and the split
    # leaves it alone.  The steps keep every merge of the split several
    # ppm from the next (precursors within a cluster spread by 2 ppm), so
    # that the store's float32 m/z and the reference's float64 cut alike.
    c = generator.quantize(_with_shifted_copies(
        c, np.arange(0, len(c), 25), (5.0, 22.0)))
    mgf = str(tmp / "in.mgf")
    generator.write_mgf(mgf, c)
    return tmp, mgf, c


@pytest.fixture(scope="module", params=[
    (2**32 + 11, (2,), 24),
    (2**31 + 3, (2, 3), 30),
], ids=["one_charge", "two_charges"])
def corpus(request, tmp_path_factory):
    """About 1,000 spectra in clusters of 2..40 (P(s) ~ s^-2, as the
    project mix) and noise, in a few dozen precursor classes, with chains
    of shifted copies that the refinement splits."""
    seed, charges, classes = request.param
    sizes = generator.power_law_sizes(800, 2.0, 2, 40, seed % 1000)
    return _corpus(tmp_path_factory.mktemp("dbscan_deployment"), seed,
                   sizes, 200, charges, classes)


@pytest.fixture(scope="module")
def pairs_corpus(tmp_path_factory):
    """Clusters of two spectra beside clusters of 3..12: at min_samples 3
    no member of a pair is core, where single linkage keeps the pair."""
    sizes = [2] * 60 + list(range(3, 13)) * 3
    return _corpus(tmp_path_factory.mktemp("dbscan_pairs"), 2**32 + 29,
                   sizes, 60, (2,), 12)


@pytest.fixture()
def on_cpu(monkeypatch):
    monkeypatch.setenv(DEVICE_ENV, "cpu")


def _labels(tmp, mgf, c, flags, name, record=False):
    """(labels by spectrum, CSV bytes) of one CLI call."""
    out = tmp / name
    if record:
        profiler.start_recording()
    try:
        assert cli.main([mgf, str(out), "--work_dir", str(tmp / "work"),
                         "--overwrite", *flags]) == 0
    finally:
        profiler.stop_recording()
    csv = Path(f"{out}.csv")
    return read_csv_labels(str(csv), len(c))[c.scan], csv.read_bytes()


def _with_min_samples(n):
    flags = list(FLAGS)
    flags[flags.index("--min_samples") + 1] = str(n)
    return flags


def _components(nb, core):
    """Component id of each core row over the core-core edges of ``nb``
    (-1 elsewhere), by breadth-first search from the lowest row."""
    comp = np.full(len(core), -1, np.int64)
    n_comp = 0
    for start in np.flatnonzero(core):
        if comp[start] >= 0:
            continue
        comp[start] = n_comp
        frontier = [start]
        while frontier:
            i = frontier.pop()
            for j in np.flatnonzero(nb[i] & core & (comp < 0)):
                comp[j] = n_comp
                frontier.append(j)
        n_comp += 1
    return comp


def brute_dbscan(c, settings, min_samples):
    """Labels of each spectrum of ``c`` (-1 = dropped by preprocessing),
    with a stats dict, by DBSCAN from its definition on falcon's graph:
    per charge, two spectra are neighbours when their precursors lie
    within the tolerance (ppm of the smaller) and their peak-matching
    cosine distance is at most ``eps``; a core spectrum has at least
    ``min_samples`` spectra in its neighbourhood, itself included;
    clusters are the components of the core-core graph; a border
    spectrum joins its most similar core neighbour (the first on a tie);
    a cluster of one is noise.  Each cluster is then split where its
    precursors span more than the tolerance (complete linkage of the ppm
    distance), and a group of fewer than ``max(min_samples, 2)`` spectra
    is noise, as falcon refines clusters."""
    s = reference.exact_settings(settings)
    eps, tol = settings["eps"], s["precursor_tol_ppm"]
    kept, mz_pad, int_pad = reference.preprocess(c, s)
    mz_t, int_t = torch.from_numpy(mz_pad), torch.from_numpy(int_pad)
    labels = np.full(len(c), -1, np.int64)
    stats = {"core": 0, "split": 0, "demoted": 0, "clusters": 0}
    charge, pmz_all = c.charge[kept], c.precursor_mz[kept]
    next_label = 0
    floor = max(min_samples, 2)
    for z in np.unique(charge):
        rows = np.flatnonzero(charge == z)
        rows = rows[np.argsort(pmz_all[rows], kind="stable")]
        pmz, m = pmz_all[rows], len(rows)
        ii, jj = np.triu_indices(m, 1)
        ppm = np.abs(pmz[ii] - pmz[jj]) / np.minimum(pmz[ii], pmz[jj]) * 1e6
        ii, jj = ii[ppm <= tol], jj[ppm <= tol]
        dist = np.full((m, m), np.inf)
        if len(ii):
            d = reference.pair_distances(
                mz_t, int_t, torch.from_numpy(rows[ii]),
                torch.from_numpy(rows[jj]), s["fragment_tol"],
                s["min_matches"], torch.float32).numpy().astype(np.float64)
            dist[ii, jj] = dist[jj, ii] = d
        nb = dist <= eps
        core = nb.sum(1) + 1 >= min_samples
        stats["core"] += int(core.sum())
        comp = _components(nb, core)
        for i in np.flatnonzero(~core):
            cand = np.flatnonzero(nb[i] & core)
            if len(cand):
                comp[i] = comp[cand[np.argmin(dist[i, cand])]]
        ids, counts = np.unique(comp[comp >= 0], return_counts=True)
        for cid in ids[counts >= 2]:
            members = np.flatnonzero(comp == cid)
            p = pmz[members]
            split = (p.max() - p.min()) / p.min() * 1e6 > tol
            groups = (reference._split_precursors(p, tol) if split
                      else np.zeros(len(members), np.int64))
            stats["split"] += split
            kept_any = False
            for g in np.unique(groups):
                part = members[groups == g]
                if len(part) >= floor:
                    labels[kept[rows[part]]] = next_label
                    next_label += 1
                    stats["clusters"] += 1
                    kept_any = True
            stats["demoted"] += not kept_any
        alone = kept[rows[labels[kept[rows]] < 0]]
        labels[alone] = next_label + np.arange(len(alone))
        next_label += len(alone)
    return labels, stats


def test_the_config_reads_as_single_linkage():
    """The reference reads the deployment as single linkage cut at eps,
    the flags are the settings, and nothing was cut from the source."""
    s = reference.exact_settings(SETTINGS)
    assert (s["linkage"], s["threshold"]) == ("single", SETTINGS["eps"])
    assert (SETTINGS["cluster_method"], SETTINGS["min_samples"]) == (
        "dbscan", 2)
    for flag, key in (("--eps", "eps"), ("--min_samples", "min_samples"),
                      ("--cluster_method", "cluster_method"),
                      ("--backend", "backend")):
        assert FLAGS[FLAGS.index(flag) + 1] == str(SETTINGS[key])
    assert DBSCAN["reduced"] == []


def test_dbscan_gives_the_single_linkage_reference(corpus, on_cpu):
    tmp, mgf, c = corpus
    labels, _ = _labels(tmp, mgf, c, FLAGS, "reference")
    ref = reference.cluster(c, reference.exact_settings(SETTINGS),
                            torch.device("cpu"))
    assert reference.disagreement(labels, ref) == 0
    # Not every spectrum alone: the corpus has clusters to find.
    assert len(np.unique(labels)) < 0.8 * len(labels)


def test_dbscan_gives_the_brute_force_dbscan(corpus, on_cpu):
    tmp, mgf, c = corpus
    labels, _ = _labels(tmp, mgf, c, FLAGS, "brute")
    brute, _ = brute_dbscan(c, SETTINGS, 2)
    assert reference.disagreement(labels, brute) == 0


def _without_work_dir(csv: bytes) -> bytes:
    return b"".join(line for line in csv.splitlines(keepends=True)
                    if not line.startswith(b"# work_dir = "))


def test_dbscan_writes_the_jax_packages_csv(corpus, on_cpu):
    tmp, mgf, c = corpus
    _, csv = _labels(tmp, mgf, c, FLAGS, "port")
    out = tmp / "port_jax"
    assert jax_cli.main([mgf, str(out), "--work_dir", str(tmp / "w_jax"),
                         "--overwrite", *FLAGS]) == 0
    assert _without_work_dir(csv) == _without_work_dir(
        Path(f"{out}.csv").read_bytes())


def test_min_samples_3_departs_from_single_linkage(pairs_corpus, on_cpu):
    """On clusters of two, DBSCAN at min_samples 3 leaves both spectra
    alone where single linkage keeps the pair; at min_samples 2 the two
    agree.  The port follows the brute-force DBSCAN at both."""
    tmp, mgf, c = pairs_corpus
    ref = reference.cluster(c, reference.exact_settings(SETTINGS),
                            torch.device("cpu"))
    two, _ = brute_dbscan(c, SETTINGS, 2)
    three, stats = brute_dbscan(c, SETTINGS, 3)
    assert reference.disagreement(two, ref) == 0
    assert reference.disagreement(three, ref) > 0.1
    assert stats["core"] < (ref >= 0).sum()
    port, _ = _labels(tmp, mgf, c, _with_min_samples(3), "three",
                      record=True)
    assert reference.disagreement(port, three) == 0
    # Clusters of a core and one border, or split into groups of two,
    # fall below min_samples and are demoted.
    counters = profiler.counters()
    assert stats["demoted"] > 0
    for name in ("core", "clusters", "split", "demoted"):
        key = "ann.dbscan.core" if name == "core" else f"ann.refine.{name}"
        assert counters[key] == stats[name], name


def test_recorder_holds_the_dbscan_counters(corpus, on_cpu):
    """The counters read what the brute-force DBSCAN counts: core rows,
    clusters kept, split and demoted; the propagation ran; the medoid
    launch scored at least each cluster's spanning edges and at most
    every ordered pair of it; and recording changes no CSV byte."""
    tmp, mgf, c = corpus
    labels, off = _labels(tmp, mgf, c, FLAGS, "off")
    _, on = _labels(tmp, mgf, c, FLAGS, "on", record=True)
    assert on == off
    counters = profiler.counters()
    assert set(COUNTERS) <= set(counters)
    _, stats = brute_dbscan(c, SETTINGS, 2)
    assert stats["split"] > 0
    for name in ("core", "clusters", "split", "demoted"):
        key = "ann.dbscan.core" if name == "core" else f"ann.refine.{name}"
        assert counters[key] == stats[name], name
    assert counters["ann.dbscan.rounds"] >= len(np.unique(c.charge))
    _, sizes = np.unique(labels, return_counts=True)
    sizes = sizes[sizes >= 2]
    assert len(sizes) == stats["clusters"]
    assert (sizes - 1).sum() <= counters["ann.medoids.listed"] <= (
        sizes * (sizes - 1)).sum()
