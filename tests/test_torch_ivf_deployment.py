"""falcon's published IVF deployment (``--backend ann --ann_index ivf
--n_probe 32``, the README's settings on falcon's IVF index) through the
port's CLI on the CPU: with every list probed it gives the plain
reference's labels and the default index's; at ``--n_probe 32`` it stays
within the benchmark cell's limit and writes the JAX package's CSV bytes;
rows that spill out of their full lists are
placed as the JAX package places them; the recorder holds the IVF phases,
counters and gauge; and the CSV bytes are the same with recording on and
off."""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from falcon_tpu import cli as jax_cli
from falcon_tpu.ops import ivf as jax_ivf
from falcon_tpu_torch import cli
from falcon_tpu_torch.device import DEVICE_ENV
from falcon_tpu_torch.ops import ivf
from falcon_tpu_torch.utils.profiling import profiler
from portbench import generator, reference
from portbench.run import read_csv_labels

REPO = Path(__file__).resolve().parents[1]
DEFAULT = json.loads(
    (REPO / "portbench/configs/ann-default.json").read_text())
IVF = json.loads((REPO / "portbench/configs/ann-ivf.json").read_text())
LIMIT = json.loads(
    (REPO / "portbench/limits/ann-ivf-262k.json").read_text())
SETTINGS = reference.exact_settings(DEFAULT["settings"])
IVF_FLAGS = IVF["flags"]
PHASES = ("ivf: train", "ivf: place", "ivf: probe", "ivf: cut")
COUNTERS = ("ivf.lists", "ivf.cap", "ivf.train_rows", "ivf.kmeans_steps",
            "ivf.chunks", "ivf.probes", "ivf.spilled_rows",
            "ann.rerank.width")


def _with_copies(c: generator.Corpus, rows: np.ndarray) -> generator.Corpus:
    """``c`` with exact copies of ``rows`` appended (new scan numbers)."""
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
        precursor_mz=cat(c.precursor_mz), charge=cat(c.charge),
        rt=cat(c.rt), truth=cat(c.truth), is_noise=cat(c.is_noise),
        group=cat(c.group), member=cat(c.member),
        scan=np.concatenate([c.scan, len(c) + np.arange(len(rows))]))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """One charge of 1,500 spectra (so 64 IVF lists, more than 32) in
    clusters of 2..30 and noise, every ninth spectrum copied exactly."""
    sizes = generator.power_law_sizes(1100, 2.0, 2, 30, 11)
    c = generator.make_clustered_spectra(
        n_clusters=len(sizes), cluster_size=sizes, n_noise=233,
        charges=(2,), precursor_classes=40, seed=2**32 + 5)
    c = generator.quantize(_with_copies(c, np.arange(0, len(c), 9)))
    tmp = tmp_path_factory.mktemp("ivf_deployment")
    mgf = str(tmp / "in.mgf")
    generator.write_mgf(mgf, c)
    return tmp, mgf, c


@pytest.fixture()
def on_cpu(monkeypatch):
    monkeypatch.setenv(DEVICE_ENV, "cpu")


@pytest.fixture()
def indexes(monkeypatch):
    """(n_lists, largest list, probes searched) of each IVF index built."""
    seen = []
    init, search = ivf.IVFIndex.__init__, ivf.IVFIndex.self_search

    def spy_init(self, *a, **k):
        init(self, *a, **k)
        seen.append({"n_lists": self.n_lists, "largest": self._max_list})

    def spy_search(self, k, n_probe=32, **kw):
        seen[-1]["probes"] = min(n_probe, self.n_lists)
        return search(self, k, n_probe=n_probe, **kw)

    monkeypatch.setattr(ivf.IVFIndex, "__init__", spy_init)
    monkeypatch.setattr(ivf.IVFIndex, "self_search", spy_search)
    return seen


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


def _ivf_flags(n_probe):
    flags = list(IVF_FLAGS)
    flags[flags.index("--n_probe") + 1] = str(n_probe)
    return flags


def test_every_list_probed_gives_the_reference(corpus, on_cpu, indexes):
    tmp, mgf, c = corpus
    labels, _ = _labels(tmp, mgf, c, _ivf_flags(4096), "all")
    assert [i["probes"] for i in indexes] == [i["n_lists"] for i in indexes]
    ref = reference.cluster(c, SETTINGS, torch.device("cpu"))
    default, _ = _labels(tmp, mgf, c, DEFAULT["flags"], "default")
    assert reference.disagreement(labels, ref) == 0
    assert reference.disagreement(labels, default) == 0
    # The copies share their originals' clusters.
    assert (labels >= 0).all()


def test_n_probe_32_stays_within_the_cells_limit(corpus, on_cpu, indexes):
    tmp, mgf, c = corpus
    labels, _ = _labels(tmp, mgf, c, IVF_FLAGS, "limit")
    assert indexes and all(i["probes"] == 32 < i["n_lists"]
                           for i in indexes)
    assert reference.exact_settings(IVF["settings"]) == SETTINGS
    ref = reference.cluster(c, SETTINGS, torch.device("cpu"))
    assert reference.disagreement(labels, ref) <= LIMIT["label_disagree"]


def _without_work_dir(csv: bytes) -> bytes:
    return b"".join(line for line in csv.splitlines(keepends=True)
                    if not line.startswith(b"# work_dir = "))


def test_n_probe_32_gives_the_jax_packages_csv(corpus, on_cpu, indexes):
    tmp, mgf, c = corpus
    _, csv = _labels(tmp, mgf, c, IVF_FLAGS, "p32")
    assert indexes and all(i["probes"] == 32 < i["n_lists"]
                           for i in indexes)
    out = tmp / "p32_jax"
    assert jax_cli.main([mgf, str(out), "--work_dir", str(tmp / "w_jax"),
                         "--overwrite", *IVF_FLAGS]) == 0
    assert _without_work_dir(csv) == _without_work_dir(
        Path(f"{out}.csv").read_bytes())


def test_recorder_holds_the_ivf_phases_and_counters(corpus, on_cpu,
                                                    indexes):
    tmp, mgf, c = corpus
    _, off = _labels(tmp, mgf, c, IVF_FLAGS, "off")
    indexes.clear()
    _, on = _labels(tmp, mgf, c, IVF_FLAGS, "on", record=True)
    assert on == off
    names = {s.name for s in profiler.spans()}
    assert set(PHASES) <= names
    counters = profiler.counters()
    assert set(COUNTERS) <= set(counters)
    assert 0 < counters["ivf.probes"]
    assert counters["ivf.lists"] == sum(i["n_lists"] for i in indexes)
    assert counters["ivf.largest_list.max"] == max(
        i["largest"] for i in indexes)
    assert counters["ivf.kmeans_steps"] == 10 * len(indexes)
    assert counters["ivf.chunks"] >= len(indexes)
    assert counters["ivf.train_rows"] > 0 and counters["ivf.cap"] > 0
    assert 16 <= counters["ann.rerank.width"]
    # Every IVF phase lies inside the engine's ``ann: knn``.
    by_id = {s.id: s for s in profiler.spans()}
    for s in profiler.spans():
        if s.name in PHASES:
            assert by_id[s.parent].name == "ann: knn"


def test_spilled_rows_are_placed_as_the_jax_package_places_them(
        on_cpu, monkeypatch, caplog):
    """2,000 copies of one vector fill their 8 nearest lists (of 128 rows
    each), so the rest spill round-robin; on the JAX package's centroids
    the port lays every row out as the JAX package does, and the recorder
    counts the rows outside their first list."""
    rng = np.random.default_rng(4)
    vecs = rng.normal(size=(3000, 64))
    vecs[:2000] = vecs[0]
    vecs = (vecs / np.linalg.norm(vecs, axis=1, keepdims=True)).astype(
        np.float32)
    mzs = np.linspace(500.0, 501.0, len(vecs))
    want = jax_ivf.IVFIndex(vecs, mzs, n_lists=64, seed=42)
    monkeypatch.setattr(ivf, "_kmeans_fit", lambda *a: torch.from_numpy(
        np.array(want.centroids)))
    profiler.start_recording()
    try:
        with caplog.at_level("WARNING", logger="falcon_tpu"):
            got = ivf.IVFIndex(vecs, mzs, n_lists=64, seed=42, device="cpu")
    finally:
        profiler.stop_recording()
    assert "spilled" in caplog.text
    assert got.n_lists == want.n_lists and got._lb == want._lb
    for name in ("order", "offsets", "mzs", "rows", "_row3d_host"):
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(want, name)))
    np.testing.assert_array_equal(got._corpus3d.float().numpy(),
                                  np.asarray(want._corpus3d.astype(
                                      jnp.float32)))
    first = ivf._assign_topk(torch.from_numpy(vecs),
                             torch.from_numpy(got.centroids), 1).numpy()[:, 0]
    placed = np.empty(len(vecs), np.int64)
    placed[got.order] = np.repeat(np.arange(got.n_lists),
                                  np.diff(got.offsets))
    spilled = int((placed != first).sum())
    assert spilled > 0
    assert profiler.counters()["ivf.spilled_rows"] == spilled
