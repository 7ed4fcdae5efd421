"""``--devices N`` on the port against the JAX package on the CPU: the
mesh's collectives, the halo k-NN, the sharded ann pipeline, its medoid
scores, the linkage over the mesh, the block scheduler and the CLI.

The JAX package runs on the 8 virtual CPU devices of ``tests/conftest.py``;
the port on N virtual shards of the CPU (``FALCON_TPU_TORCH_VIRTUAL_DEVICES``,
set per test).  Inputs are made from seeds with numpy.  Collectives equal
NumPy (``psum`` the JAX package's bits, twice the same bytes); band windows
are equal; the halo k-NN's ids are equal and its scores within 1e-6 (the
two frameworks' float32 products); the sharded pipeline's labels, the
halo-pool rerank and the sharded medoid scores are equal bit for bit; and
``generate_clusters(devices=N)`` and the CLI give the JAX package's labels,
medoids and CSV bytes at N = 2, 4 and 8, on a corpus with 30 duplicated
spectra (dbscan mode's medoids tie between copies).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from falcon_tpu import cli as jax_cli
from falcon_tpu.cluster import ann_engine as jax_engine
from falcon_tpu.ops import pairwise as jax_pairwise
from falcon_tpu.ops.rerank import rerank_scan_body as jax_rerank_body
from falcon_tpu.ops.vectorize import SpectrumHasher as JaxHasher
from falcon_tpu.parallel import mesh as jax_mesh
from falcon_tpu.parallel import sharded_knn as jax_knn
from falcon_tpu.parallel import sharded_pipeline as jax_pipeline
from falcon_tpu.preprocess import process_spectrum
from falcon_tpu.simulate import make_clustered_spectra, write_mgf
from falcon_tpu.store.store import SpectrumStore, padded_peaks
from falcon_tpu_torch import cli
from falcon_tpu_torch.cluster import ann_engine
from falcon_tpu_torch.utils.profiling import profiler
from falcon_tpu_torch.device import (DEVICE_ENV, VIRTUAL_DEVICES_ENV,
                                     visible_devices)
from falcon_tpu_torch.ops import pairwise
from falcon_tpu_torch.ops.rerank import rerank_exact
from falcon_tpu_torch.ops.vectorize import SpectrumHasher
from falcon_tpu_torch.parallel import mesh, sharded_knn, sharded_pipeline

TOL = 0.05
CPU = torch.device("cpu")


@pytest.fixture()
def shards(monkeypatch):
    """Set the number of virtual CPU shards; returns a mesh factory."""
    def make(n):
        monkeypatch.setenv(VIRTUAL_DEVICES_ENV, str(n))
        return mesh.make_mesh(n, device="cpu")
    return make


def _rows():
    # ~790 spectra crowded into 2 m/z (bands of ~10 rows that cross the
    # 512-row shards), and 30 copies of spectra (same peaks, precursor and
    # RT, new identifiers).
    spectra, _ = make_clustered_spectra(
        n_clusters=60, cluster_size=6, n_noise=400, seed=5, charges=(2,),
        precursor_mz_range=(600.0, 602.0))
    rows = [process_spectrum(s, 5, 250, 101.0, 1500.0, 1.5, 0.01, 50, None)
            for s in spectra]
    rows = [r for r in rows if r is not None]
    return rows + [dict(r, identifier=r["identifier"] + "_copy")
                   for r in rows[1::9][:30]]


@pytest.fixture(scope="module")
def rows():
    return _rows()


@pytest.fixture(scope="module")
def dataset(rows, tmp_path_factory):
    store = SpectrumStore(str(tmp_path_factory.mktemp("parallel_spectra")))
    writer = store.writer(batch_size=97)
    writer.add_many(rows)
    writer.close()
    return store.dataset(2)


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


def test_visible_devices_counts_virtual_shards(monkeypatch):
    monkeypatch.delenv(VIRTUAL_DEVICES_ENV, raising=False)
    assert visible_devices(CPU) == [CPU]
    monkeypatch.setenv(VIRTUAL_DEVICES_ENV, "3")
    assert visible_devices(CPU) == [CPU] * 3
    assert mesh.make_mesh(2, device="cpu").devices == (CPU, CPU)
    with pytest.raises(ValueError, match="3 visible"):
        mesh.make_mesh(4, device="cpu")
    monkeypatch.setenv(VIRTUAL_DEVICES_ENV, "0")
    with pytest.raises(ValueError, match=">= 1"):
        visible_devices(CPU)


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_collectives_match_numpy(shards, n_dev):
    m = shards(n_dev)
    rng = np.random.default_rng(n_dev)
    # Magnitudes 1e-8 .. 1e8: the order of a float32 sum shows in its bits.
    x = (rng.standard_normal((n_dev, 64))
         * 10.0 ** rng.integers(-8, 8, (n_dev, 64))).astype(np.float32)
    parts = mesh.shard_rows(m, torch.from_numpy(x.reshape(-1)))
    assert [p.shape for p in parts] == [(64,)] * n_dev
    right = mesh.ppermute(m, parts, [(i, (i + 1) % n_dev)
                                     for i in range(n_dev)])
    for i in range(n_dev):
        np.testing.assert_array_equal(right[i].numpy(), x[i - 1])
    for got in mesh.all_gather(m, parts):
        np.testing.assert_array_equal(got.numpy(), x.reshape(-1))
    for got in mesh.pmin(m, parts):
        np.testing.assert_array_equal(got.numpy(), x.min(axis=0))
    fold = x[0]
    for i in range(1, n_dev):
        fold = fold + x[i]
    jm = jax_mesh.make_mesh(n_dev)
    jax_sum = np.asarray(jax.jit(jax.shard_map(
        lambda a: jax.lax.psum(a, "spectra"), mesh=jm, in_specs=P("spectra"),
        out_specs=P(), check_vma=False))(x))[0]
    first = mesh.psum(m, parts)
    again = mesh.psum(m, parts)
    for got in first + again:
        assert got.numpy().tobytes() == fold.tobytes() == jax_sum.tobytes()
    with pytest.raises(ValueError):
        mesh.ppermute(m, parts, [(0, 0)])


@pytest.mark.parametrize("n_dev", [2, 4, 8])
@pytest.mark.parametrize("tol,mode", [(20.0, "ppm"), (0.05, "Da"),
                                      (20000.0, "ppm")],
                         ids=["20ppm", "0.05Da", "wide"])
def test_band_windows_match_jax(n_dev, tol, mode):
    rng = np.random.default_rng(7)
    mzs = np.sort(rng.uniform(600.0, 603.0, 3000))
    local = max(512, 1 << int(np.ceil(np.log2(3000 / n_dev))))
    block = 256
    got = sharded_knn._band_windows(mzs, tol, mode == "Da", n_dev, local,
                                    block)
    want = jax_pipeline._band_windows(mzs, tol, mode == "Da", n_dev, local,
                                      block)
    assert sharded_pipeline._band_windows is sharded_knn._band_windows
    if want is None:
        assert got is None and (tol, n_dev) != (20.0, 2)
        return
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_knn_banded_sharded_matches_jax(shards, n_dev):
    m = shards(n_dev)
    rng = np.random.default_rng(7)
    n, d, k = 3000, 128, 8
    vectors = rng.normal(size=(n, d)).astype(np.float32)
    vectors /= np.linalg.norm(vectors, axis=1, keepdims=True)
    mzs = np.sort(rng.uniform(600, 602, n))  # bands of ~36 rows
    jm = jax_mesh.make_mesh(n_dev)
    want_s, want_i = jax_knn.knn_banded_sharded(vectors, mzs, 20.0, "ppm",
                                                k, jm)
    got_s, got_i = sharded_knn.knn_banded_sharded(
        torch.from_numpy(vectors), mzs, 20.0, "ppm", k, m)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_allclose(got_s.numpy(), want_s, atol=1e-6, rtol=0)
    assert (want_i >= 0).all()  # full lists, some across shards
    # Bands of every row: wider than one shard's halo from 4 shards of
    # 1,024 rows on (no result, in both packages); 2 shards of 2,048 rows
    # hold them.
    wide = (jax_knn.knn_banded_sharded(vectors, mzs, 2e4, "ppm", k, jm),
            sharded_knn.knn_banded_sharded(torch.from_numpy(vectors), mzs,
                                           2e4, "ppm", k, m))
    assert [w is None for w in wide] == [n_dev > 2] * 2


@pytest.mark.parametrize("n_dev,rt_tol,min_matches", [
    (2, None, 0), (4, 300.0, 4), (8, None, 0)],
    ids=["2", "4_rt_min_matches", "8"])
def test_ann_cluster_sharded_matches_jax(shards, rows, n_dev, rt_tol,
                                         min_matches):
    m = shards(n_dev)
    mz, intensity, pmz, rts = _sorted_padded(rows)
    args = (20.0, "ppm", 128, 64, TOL, 0.1, 2, min_matches, rt_tol)
    want, _, n_pad = jax_pipeline.ann_cluster_sharded(
        mz, intensity, pmz, rts if rt_tol else None,
        JaxHasher(101.0, 1500.0, TOL), *args, jax_mesh.make_mesh(n_dev))
    got, vectors, got_pad = sharded_pipeline.ann_cluster_sharded(
        mz, intensity, pmz, rts if rt_tol else None,
        SpectrumHasher(101.0, 1500.0, TOL), *args, m)
    np.testing.assert_array_equal(got, want)
    assert got_pad == n_pad and len(vectors) == n_dev
    assert len(np.unique(got[got >= 0])) > 40


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_sharded_medoid_scores_bits_equal_jax(shards, n_dev):
    m = shards(n_dev)
    rng = np.random.default_rng(n_dev)
    local, dim, n_seg = 512, 512, 300
    n_pad = local * n_dev
    v = (np.abs(rng.standard_normal((n_pad, dim)))
         * (rng.random((n_pad, dim)) < 0.1)).astype(np.float32)
    v[1::5] = v[::5][:len(v[1::5])]  # copies tie
    v /= np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-12)
    v = v.astype(np.float32)
    n = n_pad - 100
    seg = rng.integers(0, n_seg, n).astype(np.int32)
    jm = jax_mesh.make_mesh(n_dev)
    want = jax_pipeline.sharded_medoid_scores(
        jax.device_put(v, NamedSharding(jm, P("spectra"))), seg, n_seg, jm)
    parts = mesh.shard_rows(m, torch.from_numpy(v))
    got = sharded_pipeline.sharded_medoid_scores(parts, seg, n_seg, m)
    again = sharded_pipeline.sharded_medoid_scores(parts, seg, n_seg, m)
    assert got.tobytes() == np.asarray(want).tobytes() == again.tobytes()


def test_halo_pool_rerank_bits_equal_jax(rows):
    # Queries and the pool apart, as on a shard: the queries are rows
    # 100..299, the pool rows 0..599, ids relative to the pool.
    mz, intensity, _, _ = _sorted_padded(rows)
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 600, (200, 40))
    ids[rng.random(ids.shape) < 0.2] = -1
    ids[:, 0] = np.arange(100, 300)  # the query itself: a perfect score
    q_mz, q_int = mz[100:300], intensity[100:300]
    want = jax_rerank_body(jnp.asarray(q_mz), jnp.asarray(q_int),
                           jnp.asarray(mz[:600]), jnp.asarray(
                               intensity[:600]), jnp.asarray(ids, jnp.int32),
                           TOL, 16, 4, 200, 16)
    got = rerank_exact(torch.from_numpy(q_mz), torch.from_numpy(q_int),
                       torch.from_numpy(ids), TOL, 16, 4,
                       pool=(torch.from_numpy(mz[:600]),
                             torch.from_numpy(intensity[:600])))
    for g, w in zip(got, want):
        assert g.numpy().tobytes() == np.asarray(w).astype(
            g.numpy().dtype).tobytes()
    assert float(got[0][:, 0].min()) > 0.99


def _generate(module, dataset, **kw):
    args = dict(eps=0.1, min_samples=2, min_matches=0,
                precursor_tol_mass=20.0, precursor_tol_mode="ppm",
                rt_tol=None, fragment_tol=TOL, batch_size=2**15)
    args.update(kw)
    if module is ann_engine:
        return ann_engine.generate_clusters(dataset, device="cpu", **args)
    return jax_engine.generate_clusters(dataset, **args)


@pytest.mark.parametrize("n_dev,kw", [
    (2, dict()),
    (4, dict(cluster_method="dbscan")),
    (8, dict(rerank="off")),
    (4, dict(rerank="off", cluster_method="dbscan")),
    (2, dict(cluster_method="dbscan", min_samples=3, rt_tol=300.0,
             min_matches=4)),
    (8, dict(linkage="single", rt_tol=300.0, min_matches=4)),
], ids=["2_linkage", "4_dbscan", "8_rerank_off", "4_rerank_off_dbscan",
        "2_dbscan_rt_min_matches", "8_single_rt_min_matches"])
def test_generate_clusters_devices_matches_jax(shards, dataset, n_dev, kw,
                                               caplog):
    shards(n_dev)
    with caplog.at_level("INFO", logger="falcon_tpu"):
        got = _generate(ann_engine, dataset, devices=n_dev, **kw)
        want = _generate(jax_engine, dataset, devices=n_dev, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert len(np.unique(got[0])) < 0.9 * len(got[0])
    # Both packages took their sharded path: no fallback was logged.
    assert "shard halo" not in caplog.text and "visible" not in caplog.text


def test_linkage_over_the_mesh_matches_jax(shards, dataset, monkeypatch):
    # Components over 5 spectra are large: each is scored on a thread of
    # its device, the small ones round-robin over the mesh.
    shards(4)
    monkeypatch.setattr(ann_engine, "LINKAGE_GROUP_MAX", 5)
    monkeypatch.setenv("FALCON_TPU_LINKAGE_GROUP_MAX", "5")
    seen = {"grouped": [], "pruned": []}
    grouped, pruned = (pairwise.condensed_distance_groups,
                       pairwise.pruned_condensed_distances)

    def spy_grouped(*args, **kw):
        seen["grouped"].append(kw.get("devices"))
        return grouped(*args, **kw)

    def spy_pruned(*args, **kw):
        seen["pruned"].append(kw.get("device"))
        return pruned(*args, **kw)

    monkeypatch.setattr(pairwise, "condensed_distance_groups", spy_grouped)
    monkeypatch.setattr(pairwise, "pruned_condensed_distances", spy_pruned)
    got = _generate(ann_engine, dataset, devices=4, eps=0.3)
    want = _generate(jax_engine, dataset, devices=4, eps=0.3)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert seen["grouped"] == [(CPU,) * 4]
    assert len(seen["pruned"]) > 4


def test_grouped_distances_round_robin_equal_one_device(rows):
    rows = sorted(rows, key=lambda r: r["precursor_mz"])
    offsets = np.zeros(len(rows) + 1, np.int64)
    offsets[1:] = np.cumsum([len(r["mz"]) for r in rows])
    ragged = (offsets, np.concatenate([r["mz"] for r in rows]),
              np.concatenate([r["intensity"] for r in rows]))
    mz, intensity, _, _ = _sorted_padded(rows)
    sizes = [2, 5, 3, 9, 4, 7, 6, 2]
    bounds = np.cumsum([0] + sizes)
    peaks = [(mz[a:b], intensity[a:b]) for a, b in zip(bounds[:-1],
                                                         bounds[1:])]
    args = (ragged, 64, np.arange(bounds[-1]), bounds, TOL, 2)
    one = list(pairwise.condensed_distance_groups(
        *args, max_group_pairs=20, device="cpu"))
    many = list(pairwise.condensed_distance_groups(
        *args, max_group_pairs=20, devices=[CPU] * 3))
    ref = {i: d for i, d in jax_pairwise.grouped_condensed_distances(
        peaks, TOL, 2)}
    assert len(one) > 3
    assert ([g.tolist() for g, _ in one] == [g.tolist() for g, _ in many])
    assert np.concatenate([g for g, _ in one]).tolist() == list(range(8))
    for (groups, a), (_, b) in zip(one, many):
        np.testing.assert_array_equal(a, b)
        pair_at = 0
        for i in groups.tolist():
            m = sizes[i]
            np.testing.assert_allclose(a[pair_at:pair_at + m * (m - 1) // 2],
                                       ref[i], atol=1e-6)
            pair_at += m * (m - 1) // 2
        assert pair_at == len(a)


@pytest.fixture(scope="module")
def jax_blocks(dataset):
    """The JAX package's labels and medoids with 128-spectrum blocks, on
    one device and round-robin over 4."""
    old = os.environ.get("FALCON_TPU_DEVICE_BLOCK_CAP")
    os.environ["FALCON_TPU_DEVICE_BLOCK_CAP"] = "128"
    try:
        return {n: _generate(jax_engine, dataset, devices=n)
                for n in (None, 4)}
    finally:
        if old is None:
            del os.environ["FALCON_TPU_DEVICE_BLOCK_CAP"]
        else:
            os.environ["FALCON_TPU_DEVICE_BLOCK_CAP"] = old


@pytest.mark.parametrize("depth,n_dev", [("1", None), ("2", None),
                                         ("2", 4)],
                         ids=["serial", "two_deep", "round_robin_4"])
def test_block_pipeline_matches_serial_and_jax(shards, dataset, jax_blocks,
                                               monkeypatch, caplog, depth,
                                               n_dev):
    monkeypatch.setenv("FALCON_TPU_DEVICE_BLOCK_CAP", "128")
    monkeypatch.setenv("FALCON_TPU_BLOCK_PIPELINE", depth)
    if n_dev:
        shards(n_dev)
    profiler.start_recording()
    try:
        with caplog.at_level("INFO", logger="falcon_tpu"):
            got = _generate(ann_engine, dataset, devices=n_dev)
    finally:
        profiler.stop_recording()
    gauge = profiler.counters()["ann.blocks_in_flight.max"]
    assert "device blocks (cap 128)" in caplog.text
    want = jax_blocks[n_dev]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], jax_blocks[None][0])
    if depth == "1":
        assert gauge == 1
    else:
        assert gauge >= 2
    if n_dev:
        assert "round-robin over 4 devices" in caplog.text


@pytest.mark.parametrize("sharded", ["ann_cluster_sharded",
                                     "knn_banded_sharded"])
def test_band_wider_than_halo_falls_back_with_a_warning(
        shards, dataset, monkeypatch, caplog, sharded):
    shards(4)
    monkeypatch.setattr(ann_engine, sharded, lambda *a, **k: None)
    kw = dict(cluster_method="dbscan")
    if sharded == "knn_banded_sharded":
        kw.update(rerank="off")
    with caplog.at_level("WARNING", logger="falcon_tpu"):
        got = _generate(ann_engine, dataset, devices=4, **kw)
    assert "wider than one shard halo" in caplog.text
    want = _generate(ann_engine, dataset, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("n_dev,flags", [
    (4, ["--backend", "ann"]),
    (2, ["--backend", "ann", "--cluster_method", "dbscan"]),
    (8, ["--backend", "ann", "--rerank", "off"]),
], ids=["4_ann", "2_ann_dbscan", "8_ann_rerank_off"])
def test_cli_devices_csv_identical_to_jax(tmp_path, monkeypatch, n_dev,
                                          flags):
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    monkeypatch.setenv(VIRTUAL_DEVICES_ENV, str(n_dev))
    spectra, _ = make_clustered_spectra(
        n_clusters=10, cluster_size=5, n_noise=15, seed=9, charges=(2, 3))
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
