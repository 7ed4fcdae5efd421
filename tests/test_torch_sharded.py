"""The rest of ``--devices N`` on the port against the JAX package on the
CPU: the pair-sharded exact backend, the sharded exact index, the IVF ring,
``multichip_cluster_step`` and the graft entry's counterpart.

The JAX package runs on the 8 virtual CPU devices of ``tests/conftest.py``;
the port on N virtual shards of the CPU (``FALCON_TPU_TORCH_VIRTUAL_DEVICES``,
set per test).  Inputs are made from seeds with numpy, with duplicated
spectra where a tie can show.  Condensed distances and the exact index's
lists are equal bit for bit; the IVF ring's scores are within 1e-5 (float32)
and 2e-5 (bfloat16) and its ids equal wherever scores are separated (the two
frameworks' dot orders); labels, medoids and CLI CSV/MGF bytes equal the
JAX package's ``devices=N``; the one-step clustering's centroids and exact
tile are within 1e-6 and its ids equal where separated.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_graft
from falcon_tpu import cli as jax_cli
from falcon_tpu.cluster import ann_engine as jax_ann
from falcon_tpu.cluster import engine as jax_engine
from falcon_tpu.ops import ivf as jax_ivf
from falcon_tpu.ops.hashing import binning_dims, hash_bin_mapping
from falcon_tpu.parallel import mesh as jax_mesh
from falcon_tpu.parallel import sharded_exact as jax_sharded_exact
from falcon_tpu.parallel import sharded_exact_index as jax_exact_index
from falcon_tpu.parallel import sharded_ivf as jax_sharded_ivf
from falcon_tpu.preprocess import process_spectrum
from falcon_tpu.simulate import make_clustered_spectra, write_mgf
from falcon_tpu.store.store import SpectrumStore, padded_peaks
from falcon_tpu_torch import cli, graft_entry
from falcon_tpu_torch.cluster import ann_engine, engine
from falcon_tpu_torch.device import DEVICE_ENV, VIRTUAL_DEVICES_ENV
from falcon_tpu_torch.ops import ivf, pairwise
from falcon_tpu_torch.parallel import (mesh, sharded_exact,
                                       sharded_exact_index, sharded_ivf)
from falcon_tpu_torch.utils.profiling import profiler

TOL = 0.05


@pytest.fixture()
def shards(monkeypatch):
    """Set the number of virtual CPU shards; returns a mesh factory."""
    def make(n):
        monkeypatch.setenv(VIRTUAL_DEVICES_ENV, str(n))
        return mesh.make_mesh(n, device="cpu")
    return make


def _rows(n_clusters, n_noise, copies, seed=5, mz_range=(600.0, 602.0)):
    # Precursors crowded into 2 m/z (bands that cross the shards), and
    # copies of spectra (same peaks, precursor and RT, new identifiers).
    spectra, _ = make_clustered_spectra(
        n_clusters=n_clusters, cluster_size=6, n_noise=n_noise, seed=seed,
        charges=(2,), precursor_mz_range=mz_range)
    rows = [process_spectrum(s, 5, 250, 101.0, 1500.0, 1.5, 0.01, 50, None)
            for s in spectra]
    rows = [r for r in rows if r is not None]
    return rows + [dict(r, identifier=r["identifier"] + "_copy")
                   for r in rows[1::9][:copies]]


@pytest.fixture(scope="module")
def small_rows():
    return _rows(20, 60, 10)  # ~190 spectra


@pytest.fixture(scope="module")
def narrow_dataset(tmp_path_factory):
    # Precursors in 0.2 m/z: a few intervals of tens of spectra, each cut
    # over the mesh (the JAX package pads each to 4,096 pairs a device).
    return _store(_rows(12, 30, 8, seed=4, mz_range=(600.0, 600.2)),
                  tmp_path_factory.mktemp("sharded_narrow"))


@pytest.fixture(scope="module")
def rows():
    return _rows(60, 400, 30)  # ~790 spectra


def _store(rows, path):
    store = SpectrumStore(str(path))
    writer = store.writer(batch_size=97)
    writer.add_many(rows)
    writer.close()
    return store.dataset(2)


@pytest.fixture(scope="module")
def dataset(rows, tmp_path_factory):
    return _store(rows, tmp_path_factory.mktemp("sharded_spectra"))


def _sorted_padded(rows):
    rows = sorted(rows, key=lambda r: r["precursor_mz"])
    offsets = np.zeros(len(rows) + 1, np.int64)
    offsets[1:] = np.cumsum([len(r["mz"]) for r in rows])
    mz, intensity, _ = padded_peaks(
        offsets, np.concatenate([r["mz"] for r in rows]),
        np.concatenate([r["intensity"] for r in rows]), 64)
    pmz = np.array([r["precursor_mz"] for r in rows])
    rts = np.array([r["retention_time"] for r in rows])
    return mz, intensity, pmz, rts


@pytest.mark.parametrize("n_dev,min_matches,tol", [
    (2, 0, TOL), (2, 6, TOL), (4, 0, TOL), (4, 6, TOL), (8, 0, TOL),
    (8, 6, TOL), (4, 6, 0.5)],
    ids=["2", "2_min_matches", "4", "4_min_matches", "8", "8_min_matches",
         "4_wide_tol"])
def test_condensed_distances_sharded_bits_equal_jax(shards, small_rows,
                                                    n_dev, min_matches, tol):
    # At 0.5 Da a pair has tens of matched peaks: the sum order shows.
    m = shards(n_dev)
    mz, intensity, _, _ = _sorted_padded(small_rows)
    want = jax_sharded_exact.condensed_distances_sharded(
        mz, intensity, tol, min_matches, jax_mesh.make_mesh(n_dev))
    got = sharded_exact.condensed_distances_sharded(mz, intensity, tol,
                                                    min_matches, m)
    n = mz.shape[0]
    assert got.dtype == np.float32 and got.shape == (n * (n - 1) // 2,)
    assert got.tobytes() == want.tobytes()
    assert (got < 0.5).sum() > n  # close pairs scored
    if n_dev == 2 or tol != TOL:
        # The one-device path gives the same bits.
        one = pairwise.condensed_distances(mz, intensity, tol, min_matches,
                                           rounds=8, device="cpu")
        assert got.tobytes() == one.tobytes()


def test_condensed_distances_sharded_none_above_max_n(shards, small_rows,
                                                      monkeypatch):
    m = shards(4)
    mz, intensity, _, _ = _sorted_padded(small_rows)
    for module in (sharded_exact, jax_sharded_exact):
        monkeypatch.setattr(module, "MAX_N", 100)
    assert sharded_exact.condensed_distances_sharded(
        mz, intensity, TOL, 0, m) is None
    assert jax_sharded_exact.condensed_distances_sharded(
        mz, intensity, TOL, 0, jax_mesh.make_mesh(4)) is None
    for n in (0, 1):
        got = sharded_exact.condensed_distances_sharded(mz[:n],
                                                        intensity[:n], TOL,
                                                        0, m)
        assert got.dtype == np.float32 and got.shape == (0,)


def test_exact_banded_topk_sharded_matches_jax(shards, rows):
    n_dev, rt_tol, min_matches = 4, 300.0, 4
    m = shards(n_dev)
    mz, intensity, pmz, rts = _sorted_padded(rows)
    args = (mz, intensity, pmz, 20.0, "ppm", 16, TOL)
    kw = dict(rts=rts if rt_tol else None, rt_tol=rt_tol,
              min_matches=min_matches)
    want_s, want_i = jax_exact_index.exact_banded_topk_sharded(
        *args, jax_mesh.make_mesh(n_dev), **kw)
    got_s, got_i = sharded_exact_index.exact_banded_topk_sharded(
        *args, m, **kw)
    assert got_s.dtype == torch.float32 and got_i.dtype == torch.int64
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    assert got_s.numpy().tobytes() == want_s.tobytes()
    assert (want_i >= 0).sum() > 3 * len(pmz)  # lists across the shards
    assert (want_s == 0.0).any()  # zeroed pairs keep their first order


def test_exact_banded_topk_sharded_none_when_a_band_leaves_the_halo(
        shards, rows):
    # 1,600 rows in 4 shards of 512 with bands of every row: the last
    # shard's bands reach shard 0.
    m = shards(4)
    mz, intensity, _, _ = _sorted_padded(rows)
    mz, intensity = np.tile(mz, (3, 1))[:1600], np.tile(intensity,
                                                       (3, 1))[:1600]
    pmz = np.sort(np.random.default_rng(1).uniform(600.0, 602.0, 1600))
    args = (mz, intensity, pmz, 2e4, "ppm", 16, TOL)
    assert jax_exact_index.exact_banded_topk_sharded(
        *args, jax_mesh.make_mesh(4)) is None
    assert sharded_exact_index.exact_banded_topk_sharded(*args, m) is None


def _clustered(seed=0, n_centers=30, per=40, d=128):
    """``tests/test_ivf.py``'s vectors: unit vectors around 30 centres,
    with sorted precursor m/z."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_centers, d))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    vecs = np.repeat(centers, per, axis=0) + rng.normal(
        0, 0.15, (n_centers * per, d))
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    mzs = np.sort(rng.uniform(400, 1200, len(vecs)))
    return vecs.astype(np.float32), mzs


@pytest.fixture(scope="module")
def ivf_indexes():
    vecs, mzs = _clustered()
    return {precise: (jax_ivf.IVFIndex(vecs, mzs, n_lists=16, seed=42,
                                       precise=precise),
                      ivf.IVFIndex(vecs, mzs, n_lists=16, seed=42,
                                   precise=precise, device="cpu"))
            for precise in (False, True)}


def _separated(scores, tol):
    """Entries further than ``tol`` from both neighbours in their row."""
    gap = np.abs(np.diff(scores, axis=-1)) > tol
    far = np.ones(scores.shape, bool)
    far[..., 1:] &= gap
    far[..., :-1] &= gap
    return far


@pytest.mark.parametrize("n_dev", [2, 4, 8])
@pytest.mark.parametrize("precise", [False, True], ids=["bf16", "f32"])
def test_ivf_search_sharded_matches_jax(shards, ivf_indexes, n_dev, precise):
    # A wide tolerance: most probed pairs in band.
    m = shards(n_dev)
    jax_index, index = ivf_indexes[precise]
    np.testing.assert_array_equal(index._probe_ids(4),
                                  jax_index._probe_ids(4))
    want_s, want_i = jax_sharded_ivf.ivf_search_sharded(
        jax_index, 24, 4, 2e4, "ppm", jax_mesh.make_mesh(n_dev),
        precise=precise)
    before = ivf.probe_topk.launches
    got_s, got_i = (a.numpy() for a in sharded_ivf.ivf_search_sharded(
        index, 24, 4, 2e4, "ppm", m, precise=precise))
    assert ivf.probe_topk.launches == before  # CPU tensors: plain version
    assert got_s.shape == want_s.shape and got_i.dtype == np.int32
    atol = 1e-5 if precise else 2e-5
    np.testing.assert_allclose(got_s, want_s, atol=atol, rtol=0)
    missing = want_s == float(jax_ivf.NEG)
    assert ((got_i == -1) == missing).all()
    sep = _separated(want_s, 2 * atol) & ~missing
    assert sep.sum() > 0.8 * (~missing).sum()
    np.testing.assert_array_equal(got_i[sep], want_i[sep])


def test_ivf_search_sharded_none_unless_the_mesh_divides_the_lists(
        shards, ivf_indexes):
    m = shards(3)
    jax_index, index = ivf_indexes[True]
    assert jax_sharded_ivf.ivf_search_sharded(
        jax_index, 24, 4, 20.0, "ppm", jax_mesh.make_mesh(3)) is None
    assert sharded_ivf.ivf_search_sharded(index, 24, 4, 20.0, "ppm",
                                          m) is None


def test_probe_topk_takes_a_corpus_block_with_a_masked_list(ivf_indexes):
    # A ring step's corpus is one block of lists plus a list of +inf m/z;
    # probes pointing at it score nothing, the others their slots.
    _, index = ivf_indexes[True]
    lb = index._lb
    probes = torch.from_numpy(index._probe_ids(4))
    held = (probes >= 4) & (probes < 8)
    local = torch.where(held, probes - 4, 4).int().contiguous()
    block = [torch.cat([a[4:8], a.new_full((1,) + a.shape[1:], fill)])
             for a, fill in ((index._corpus3d, 0.0),
                             (index._mz3d, torch.inf),
                             (index._row3d, -1))]
    layout = (index._corpus3d, index._mz3d, index._row3d)
    got_s, got_i = ivf.probe_topk(*layout, *block, local, 2e4, False, 16, 0,
                                  16)
    masked = torch.where(held, probes, index.n_lists).int().contiguous()
    padded = [torch.cat([a, a.new_full((1,) + a.shape[1:], fill)])
              for a, fill in zip(layout, (0.0, torch.inf, -1))]
    want_s, want_i = ivf.probe_topk_plain(*layout, *padded, masked, 2e4,
                                          False, 16, 0, 16)
    assert torch.equal(got_s, want_s)
    assert torch.equal(torch.where(got_i >= 0, got_i + 4 * lb, -1), want_i)
    assert (got_i >= 0).any() and (got_i == -1).any()


def _exact(module, dataset, devices, **kw):
    args = dict(linkage="complete", distance_threshold=0.1, min_matches=0,
                precursor_tol_mass=20.0, precursor_tol_mode="ppm",
                rt_tol=None, fragment_tol=TOL, batch_size=2**15,
                devices=devices)
    args.update(kw)
    if module is engine:
        return engine.generate_clusters(dataset, device="cpu",
                                        panel_only=True, **args)
    return jax_engine.generate_clusters(dataset, backend="pallas_interpret",
                                        **args)


@pytest.mark.parametrize("n_dev,kw", [
    (2, dict()),
    (4, dict(linkage="average", min_matches=6, rt_tol=300.0)),
], ids=["2", "4_average_min_matches_rt"])
def test_exact_engine_devices_matches_jax(shards, narrow_dataset,
                                          monkeypatch, n_dev, kw, caplog):
    # Every interval takes the panel route, so every interval of two or
    # more spectra is cut over the mesh in both packages.
    shards(n_dev)
    calls = []
    sharded = engine.condensed_distances_sharded

    def spy(*args, **kwargs):
        calls.append(args[4].size)
        return sharded(*args, **kwargs)

    monkeypatch.setattr(engine, "condensed_distances_sharded", spy)
    with caplog.at_level("WARNING", logger="falcon_tpu"):
        got = _exact(engine, narrow_dataset, n_dev, **kw)
        want = _exact(jax_engine, narrow_dataset, n_dev, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert calls and set(calls) == {n_dev}
    assert "visible" not in caplog.text
    assert len(np.unique(got[0])) < 0.9 * len(got[0])


def test_exact_engine_warns_when_fewer_devices_are_visible(narrow_dataset,
                                                           caplog):
    with caplog.at_level("WARNING", logger="falcon_tpu"):
        got = _exact(engine, narrow_dataset, 4)
    assert ("Requested 4 devices but only 1 visible; exact panel scoring "
            "stays single-device") in caplog.text
    np.testing.assert_array_equal(got[0], _exact(engine, narrow_dataset,
                                                 None)[0])


def _ann(module, dataset, **kw):
    args = dict(eps=0.1, min_samples=2, min_matches=0,
                precursor_tol_mass=20.0, precursor_tol_mode="ppm",
                rt_tol=None, fragment_tol=TOL, batch_size=2**15)
    args.update(kw)
    if module is ann_engine:
        return ann_engine.generate_clusters(dataset, device="cpu", **args)
    return jax_ann.generate_clusters(dataset, **args)


@pytest.mark.parametrize("n_dev,kw", [
    (2, dict(ann_index="exact", cluster_method="dbscan", rt_tol=300.0,
             min_matches=4)),
    (8, dict(ann_index="ivf", cluster_method="dbscan", rerank="off")),
    (2, dict(ann_index="ivf", cluster_method="dbscan", rt_tol=300.0,
             min_matches=4)),
], ids=["2_exact_dbscan_rt_min_matches", "8_ivf_dbscan_rerank_off",
        "2_ivf_dbscan_rt_min_matches"])
def test_ann_engine_devices_matches_jax(shards, dataset, monkeypatch, n_dev,
                                        kw, caplog):
    shards(n_dev)
    calls = []
    name = ("exact_banded_topk_sharded" if kw["ann_index"] == "exact"
            else "ivf_search_sharded")
    search = getattr(ann_engine, name)

    def spy(*args, **kwargs):
        calls.append(1)
        return search(*args, **kwargs)

    monkeypatch.setattr(ann_engine, name, spy)
    with caplog.at_level("WARNING", logger="falcon_tpu"):
        got = _ann(ann_engine, dataset, devices=n_dev, **kw)
        want = _ann(jax_ann, dataset, devices=n_dev, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert calls  # the sharded search ran, and did not fall back
    assert "falling back" not in caplog.text and "visible" not in caplog.text
    assert len(np.unique(got[0])) < 0.9 * len(got[0])


@pytest.mark.parametrize("index,n_dev,message", [
    ("exact", 4, "wider than one shard halo; falling back to the "
                 "single-device exact index"),
    ("ivf", 3, "Mesh size does not divide the IVF list count; falling back "
               "to the single-device list scan"),
])
def test_sharded_search_falls_back_with_jax_warning(shards, dataset,
                                                    monkeypatch, caplog,
                                                    index, n_dev, message):
    shards(n_dev)
    if index == "exact":
        monkeypatch.setattr(ann_engine, "exact_banded_topk_sharded",
                            lambda *a, **k: None)
    with caplog.at_level("WARNING", logger="falcon_tpu"):
        got = _ann(ann_engine, dataset, devices=n_dev, ann_index=index,
                   cluster_method="dbscan")
    assert message in caplog.text
    want = _ann(ann_engine, dataset, ann_index=index,
                cluster_method="dbscan")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("n_dev,flags", [
    (2, []),
    (4, ["--linkage", "average", "--min_matched_peaks", "3"]),
    (4, ["--backend", "ann", "--ann_index", "exact"]),
    (2, ["--backend", "ann", "--ann_index", "ivf"]),
    (4, ["--backend", "ann", "--ann_index", "ivf", "--cluster_method",
         "dbscan", "--rerank", "off"]),
], ids=["2_exact", "4_exact_average", "4_ann_exact", "2_ann_ivf",
        "4_ann_ivf_dbscan_rerank_off"])
def test_cli_devices_bytes_identical_to_jax(tmp_path, monkeypatch, n_dev,
                                            flags):
    # The exact backend's intervals here are small: both engines take
    # their panel route, so that each interval is cut over the mesh.
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    monkeypatch.setenv(VIRTUAL_DEVICES_ENV, str(n_dev))
    if "ann" not in flags:
        for module, kw in ((engine, dict(panel_only=True)),
                           (jax_engine, dict(backend="pallas_interpret"))):
            monkeypatch.setattr(
                module, "generate_clusters",
                lambda *a, _f=module.generate_clusters, _kw=kw, **k: _f(
                    *a, **_kw, **k))
    spectra, _ = make_clustered_spectra(
        n_clusters=10, cluster_size=5, n_noise=15, seed=9, charges=(2, 3),
        precursor_mz_range=(600.0, 601.0))
    spectra += [dataclasses.replace(s, identifier=s.identifier + "_copy")
                for s in spectra[1::2][:24]]
    files = [write_mgf(str(tmp_path / "run.mgf"), spectra)]
    flags = ["--export_representatives", "--devices", str(n_dev)] + flags
    assert jax_cli.main(files + [str(tmp_path / "jax"), "--work_dir",
                                 str(tmp_path / "w_jax")] + flags) == 0
    assert cli.main(files + [str(tmp_path / "torch"), "--work_dir",
                             str(tmp_path / "w_torch")] + flags) == 0
    out = {}
    for name in ("torch.csv", "jax.csv", "torch.mgf", "jax.mgf"):
        with open(tmp_path / name, "rb") as f:
            out[name] = [line for line in f
                         if not line.startswith(b"# work_dir")]
    assert out["torch.csv"] == out["jax.csv"]
    assert out["torch.mgf"] == out["jax.mgf"]
    assert f"# devices = {n_dev}\n".encode() in out["torch.csv"]


@pytest.mark.parametrize("n_dev", [1, 4])
def test_multichip_cluster_step_matches_jax(shards, n_dev):
    m = shards(n_dev)
    n = 32 * n_dev
    mz, intensity, precursor = jax_graft._example_peaks(n=n, p=64, seed=3)
    n_bins, min_bound, _ = binning_dims(101.0, 1500.0, TOL)
    mapping = hash_bin_mapping(n_bins, 400, 0)
    rng = np.random.default_rng(42)
    centroids = rng.normal(size=(8, 512)).astype(np.float32)
    centroids /= np.linalg.norm(centroids, axis=1, keepdims=True)
    # 1,000 Da: every row's band holds the others.
    args = (mz, intensity, precursor, mapping, centroids, min_bound, TOL,
            n_bins)
    kw = dict(precursor_tol_mass=1000.0, precursor_tol_mode="Da")
    want = [np.asarray(a) for a in jax_mesh.multichip_cluster_step(
        jax_mesh.make_mesh(n_dev), *args, **kw)]
    got = [a.numpy() for a in mesh.multichip_cluster_step(m, *args, **kw)]
    for g, w in zip(got, want):
        assert g.shape == w.shape
    np.testing.assert_allclose(got[0], want[0], atol=1e-6, rtol=0)
    np.testing.assert_allclose(got[1], want[1], atol=1e-6, rtol=0)
    sep = _separated(want[1], 2e-6)
    assert sep.sum() > 0.8 * sep.size
    np.testing.assert_array_equal(got[2][sep], want[2][sep])
    np.testing.assert_allclose(got[3], want[3], atol=1e-6, rtol=0)
    assert (got[0] != centroids).any()  # the lists moved


def test_entry_matches_jax():
    jax.devices()  # the backend is up: the JAX entry probes no subprocess
    fn, args = graft_entry.entry(device="cpu")
    got = fn(*args)
    want_fn, want_args = jax_graft.entry()
    for a, b in zip(args, want_args):
        np.testing.assert_array_equal(a.numpy(), b)
    want = jax.jit(want_fn)(*want_args)
    assert [g.shape for g in got] == [w.shape for w in want]
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-6, rtol=0)
    sep = _separated(np.asarray(want[0]), 2e-6)
    np.testing.assert_array_equal(got[1].numpy()[sep],
                                  np.asarray(want[1])[sep])
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("n_dev", [2, 8])
def test_dryrun_multichip_on_the_cpu(monkeypatch, n_dev):
    monkeypatch.delenv(VIRTUAL_DEVICES_ENV, raising=False)
    graft_entry.dryrun_multichip(n_dev, device="cpu")
    # The dryrun records the mesh dispatch and checks its gauge itself.
    assert profiler.counters()["ann.blocks_in_flight.max"] >= 2
    assert os.environ.get(VIRTUAL_DEVICES_ENV) is None  # restored
