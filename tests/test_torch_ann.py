"""The port's ann backend against the JAX package's on the CPU: the
hasher, DBSCAN, the pruned linkage distances and the ann engine end to
end, with the exact index and with the default index (the upper-bound
scan and the exact rerank).

Vectors agree to 1e-6, DBSCAN labels exactly, pruned distances to 1e-6
with the same entries clamped to 1.0, and the engines' labels and medoids
exactly, through every route: small components (K4), large ones under
complete linkage (the pruned pair lists) and average linkage (K1), more
than one column pass per band, dense bands that widen the scan, the JAX
package's boundary-continued scan passes against the port's one wide
pass, RT holes in the candidate lists and device blocks.  Inputs are made
from seeds with numpy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from falcon_tpu.cluster import ann_engine as jax_engine
from falcon_tpu.ops import density as jdensity
from falcon_tpu.ops import pairwise as jp
from falcon_tpu.ops.vectorize import SpectrumHasher as JaxHasher
from falcon_tpu.preprocess import process_spectrum
from falcon_tpu.simulate import make_clustered_spectra
from falcon_tpu.store.store import SpectrumStore, padded_peaks
from falcon_tpu_torch.cluster import ann_engine
from falcon_tpu_torch.ops import density, exact_knn, pairwise, vectorize
from falcon_tpu_torch.ops.vectorize import SpectrumHasher

TOL = 0.05
ATOL = 1e-6


def _rows(**kwargs):
    spectra, _ = make_clustered_spectra(**kwargs)
    rows = [process_spectrum(s, 5, 250, 101.0, 1500.0, 1.5, 0.01, 50, None)
            for s in spectra]
    return [r for r in rows if r is not None]


@pytest.fixture(scope="module")
def rows():
    # ~160 spectra whose precursors crowd into 1 m/z.
    return _rows(n_clusters=20, cluster_size=6, n_noise=40, seed=33,
                 charges=(2,), precursor_mz_range=(600.0, 601.0))


@pytest.fixture(scope="module")
def dataset(rows, tmp_path_factory):
    store = SpectrumStore(str(tmp_path_factory.mktemp("ann_spectra")))
    writer = store.writer(batch_size=37)
    writer.add_many(rows)
    writer.close()
    return store.dataset(2)


def _padded(rows):
    offsets = np.zeros(len(rows) + 1, np.int64)
    offsets[1:] = np.cumsum([len(r["mz"]) for r in rows])
    mz, intensity, _ = padded_peaks(
        offsets, np.concatenate([r["mz"] for r in rows]),
        np.concatenate([r["intensity"] for r in rows]), 64)
    return mz, intensity


@pytest.mark.parametrize("norm", [False, True])
@pytest.mark.parametrize("spread", [False, True])
def test_vectorize_matches_jax(rows, spread, norm):
    mz, intensity = _padded(rows)
    ours = SpectrumHasher(101.0, 1500.0, TOL, 400, 3).vectorize(
        torch.from_numpy(mz), torch.from_numpy(intensity), norm=norm,
        spread=spread)
    ref = JaxHasher(101.0, 1500.0, TOL, 400, 3).vectorize(
        jnp.asarray(mz), jnp.asarray(intensity), norm=norm, spread=spread)
    assert ours.shape == (len(rows), 512) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)
    assert (ours[:, 400:] == 0).all()


@pytest.mark.parametrize("norm", [False, True])
@pytest.mark.parametrize("spread", [False, True])
def test_vectorize_sums_in_shift_then_peak_order(rows, spread, norm):
    # The kernel's order, which the plain version keeps on any device: each
    # dimension adds its hits for shift -1, 0, +1, each in peak order, in
    # float32; the norm's squares go through the halving tree.  Peaks in no
    # m/z order and peaks outside the binning range included.
    from torch_cases import permuted

    mz, intensity = permuted(*_padded(rows[:40]), seed=2)
    mz[:, 0] = 50.0  # below min_mz: no bin
    hasher = SpectrumHasher(101.0, 1500.0, TOL, 400, 3)
    got = vectorize.vectorize_plain(
        torch.from_numpy(mz), torch.from_numpy(intensity),
        torch.from_numpy(hasher.mapping.astype(np.int64)), hasher.min_bound,
        hasher.bin_size, hasher.n_bins, hasher.dim_padded, norm, spread)
    want = np.zeros((len(mz), hasher.dim_padded), np.float32)
    # XLA's binning: the product with the float32 reciprocal of the bin.
    bins = np.floor((mz - np.float32(hasher.min_bound))
                    * (np.float32(1) / np.float32(hasher.bin_size))
                    ).astype(np.int64)
    for i in range(len(mz)):
        for shift in ((-1, 0, 1) if spread else (0,)):
            for p in range(mz.shape[1]):
                b = bins[i, p] + shift
                if intensity[i, p] > 0 and 0 <= b < hasher.n_bins:
                    d = hasher.mapping[b]
                    want[i, d] = np.float32(want[i, d] + intensity[i, p])
    if norm:
        sq = want * want
        while sq.shape[1] > 1:
            half = sq.shape[1] // 2
            sq = sq[:, :half] + sq[:, half:]
        want = want / np.maximum(np.sqrt(sq), np.float32(1e-12))
    np.testing.assert_array_equal(got.numpy(), want)
    wrapped = hasher.vectorize(torch.from_numpy(mz),
                               torch.from_numpy(intensity), norm=norm,
                               spread=spread)
    assert torch.equal(wrapped, got) and vectorize.vectorize.launches == 0


@pytest.mark.parametrize("min_samples", [1, 3])
def test_dbscan_matches_jax(min_samples):
    # Quantised similarities make border attachment tie: the first
    # maximum must win, as in the JAX kernel.
    rng = np.random.default_rng(min_samples)
    n, n_pad, k = 300, 512, 6
    sims = rng.choice(np.float32([0.2, 0.75, 1.0]), (n_pad, k),
                      p=[0.7, 0.15, 0.15])
    neigh = np.arange(n_pad)[:, None] + rng.integers(-8, 9, (n_pad, k))
    neigh[(neigh < 0) | (neigh >= n) | (rng.random((n_pad, k)) < 0.1)] = -1
    ours = density.dbscan(torch.from_numpy(sims), torch.from_numpy(neigh),
                          0.3, n, min_samples)
    ref = jdensity.dbscan(jnp.asarray(sims), jnp.asarray(neigh, jnp.int32),
                          0.3, n, min_samples)
    np.testing.assert_array_equal(ours, ref)
    assert len(np.unique(ours[ours >= 0])) > 1


def _chained_spectra(n_chains, chain_len, seed, drift=3):
    """Chains of spectra in which neighbours share most peaks and distant
    members few, so one eps-component holds distances on both sides of
    eps."""
    rng = np.random.default_rng(seed)
    mz = np.full((n_chains * chain_len, 64), -1e6, np.float32)
    intensity = np.zeros((n_chains * chain_len, 64), np.float32)
    row = 0
    for _ in range(n_chains):
        base_mz = np.sort(rng.uniform(150, 1400, 30))
        base_int = rng.random(30).astype(np.float32) + 0.1
        for _ in range(chain_len):
            order = np.argsort(base_mz)
            mz[row, :30] = base_mz[order]
            intensity[row, :30] = (base_int[order]
                                   / np.linalg.norm(base_int))
            repl = rng.choice(30, drift, replace=False)
            base_mz[repl] = rng.uniform(150, 1400, drift)
            base_int[repl] = rng.random(drift).astype(np.float32) + 0.1
            row += 1
    return mz, intensity


@pytest.mark.parametrize("eps,min_matches,route", [
    (0.3, 0, "pair_list"), (0.1, 20, "pair_list"), (1.0, 0, "panel")])
def test_pruned_condensed_distances_match_jax(eps, min_matches, route,
                                              monkeypatch):
    mz, intensity = _chained_spectra(3, 50, seed=3)
    calls = {"panel": 0, "pair_list": 0}
    for name, key, module in (("condensed_distances", "panel", pairwise),
                              ("pair_list_scores", "pair_list", pairwise)):
        def counted(*a, _f=getattr(module, name), _k=key, **k):
            calls[_k] += 1
            return _f(*a, **k)
        monkeypatch.setattr(module, name, counted)
    ours = pairwise.pruned_condensed_distances(
        mz, intensity, SpectrumHasher(101.0, 1500.0, TOL), eps, TOL,
        min_matches, device="cpu")
    ref = jp.pruned_condensed_distances(
        mz, intensity, JaxHasher(101.0, 1500.0, TOL), eps, TOL, min_matches)
    assert ours.dtype == np.float32 and ours.shape == ref.shape
    np.testing.assert_array_equal(ours == 1.0, ref == 1.0)
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=0)
    assert calls[route] > 0 and sum(calls.values()) == calls[route]
    if route == "pair_list":
        assert 0 < (ours < 1.0).sum() < len(ours) // 2


def _generate(module, dataset, **kw):
    args = dict(eps=0.1, min_samples=2, min_matches=0,
                precursor_tol_mass=20.0, precursor_tol_mode="ppm",
                rt_tol=None, fragment_tol=TOL, batch_size=2**15,
                ann_index="exact", linkage="complete")
    args.update(kw)
    if module is ann_engine:
        return ann_engine.generate_clusters(dataset, device="cpu", **args)
    return jax_engine.generate_clusters(dataset, **args)


@pytest.mark.parametrize("case", ["single", "complete_large_two_passes",
                                  "average_large_min_matches_rt"])
def test_ann_engine_matches_jax(dataset, case, monkeypatch):
    kw = {}
    if case == "single":
        kw = dict(linkage="single")
    elif case == "complete_large_two_passes":
        # A 500 ppm band spans 256 columns; a tiny panel budget splits it
        # into two passes.  Components over 4 spectra take the pruned
        # pair lists.
        kw = dict(precursor_tol_mass=500.0, eps=0.2)
        monkeypatch.setattr(exact_knn, "PANEL_BYTES", 1)
    else:
        kw = dict(linkage="average", min_matches=3, rt_tol=600.0)
    large = case != "single"
    if large:
        monkeypatch.setattr(ann_engine, "LINKAGE_GROUP_MAX", 4)
        monkeypatch.setenv("FALCON_TPU_LINKAGE_GROUP_MAX", "4")
    calls = {"pruned": 0, "panel": 0, "passes": 0}
    for name, key in (("pruned_condensed_distances", "pruned"),
                      ("condensed_distances", "panel")):
        def counted(*a, _f=getattr(pairwise, name), _k=key, **k):
            calls[_k] += 1
            return _f(*a, **k)
        monkeypatch.setattr(pairwise, name, counted)
    banded = exact_knn.banded_panel_scores

    def count_passes(*a, **k):
        calls["passes"] += 1
        return banded(*a, **k)

    monkeypatch.setattr(exact_knn, "banded_panel_scores", count_passes)
    labels, medoids = _generate(ann_engine, dataset, **kw)
    ref_labels, ref_medoids = _generate(jax_engine, dataset, **kw)
    np.testing.assert_array_equal(labels, ref_labels)
    np.testing.assert_array_equal(medoids, ref_medoids)
    assert len(np.unique(labels)) < len(labels)  # something clustered
    assert calls["passes"] == (2 if case == "complete_large_two_passes"
                               else 1)
    if case == "complete_large_two_passes":
        assert calls["pruned"] > 0
    elif large:
        assert calls["panel"] > 0 and calls["pruned"] == 0


def test_unported_engine_options_raise(dataset, monkeypatch):
    # --rerank off and dbscan mode are ported (tests/test_torch_dbscan.py
    # holds them against the JAX package); the IVF index and several GPUs
    # are not.  The multi-GPU refusal is reached without a GPU: the engine
    # only counts the visible cards before it clusters.
    with pytest.raises(NotImplementedError, match="not yet ported"):
        _generate(ann_engine, dataset, ann_index="ivf")
    monkeypatch.setattr(ann_engine, "resolve_device",
                        lambda device: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        _generate(ann_engine, dataset, devices=2)


def test_multi_device_request_warns(dataset, caplog):
    with caplog.at_level("WARNING", logger="falcon_tpu"):
        labels, _ = _generate(ann_engine, dataset, devices=4)
    assert "only 1 visible" in caplog.text
    np.testing.assert_array_equal(labels, _generate(ann_engine, dataset)[0])


def test_device_blocks_split_on_gaps_and_log_forced_cuts(dataset,
                                                       monkeypatch, caplog):
    mzs = np.sort(np.concatenate([np.full(5, 500.0), np.full(3, 600.0),
                                  np.full(9, 700.0)]))
    # Gaps between the three runs: blocks coalesce up to the cap.
    np.testing.assert_array_equal(
        ann_engine._block_splits(mzs, 20.0, "ppm", 9), [0, 8, 17])
    # A run longer than the cap is cut inside, with a warning.
    with caplog.at_level("WARNING", logger="falcon_tpu"):
        splits = ann_engine._block_splits(mzs, 20.0, "ppm", 4)
    assert splits[0] == 0 and splits[-1] == 17
    assert (np.diff(splits) <= 4).all()
    assert "forced mid-run cuts" in caplog.text
    # The engine clusters each block and merges them in block order.
    monkeypatch.setenv("FALCON_TPU_DEVICE_BLOCK_CAP", "64")
    caplog.clear()
    with caplog.at_level("INFO", logger="falcon_tpu"):
        labels, medoids = _generate(ann_engine, dataset)
    assert "device blocks (cap 64)" in caplog.text
    assert len(labels) == dataset.count_rows()
    assert len(medoids) == len(np.unique(labels))
    assert len(np.unique(labels)) < len(labels)


@pytest.mark.parametrize("case", [
    "complete", "single", "average_large", "rt_min_matches",
    "widened", "jax_multipass", "device_blocks"])
def test_default_ann_engine_matches_jax(dataset, case, monkeypatch, caplog):
    kw = dict(ann_index="auto")
    if case == "single":
        kw.update(linkage="single")
    elif case == "average_large":
        kw.update(linkage="average")
    elif case == "rt_min_matches":
        kw.update(linkage="single", rt_tol=600.0, min_matches=3)
    elif case == "widened":
        # A 2000 ppm band holds every spectrum: the scan widens past
        # n_neighbors_ann = 128 to n - 1.
        kw.update(precursor_tol_mass=2000.0, eps=0.2)
    elif case == "jax_multipass":
        # The JAX package scans 4 candidates at a time in boundary-
        # continued passes (tests/test_widen.py's switches) and merges
        # their reranks into the top 4; the port scans the same coverage
        # at once and reranks it once.
        kw.update(n_neighbors=4, n_neighbors_ann=4, eps=0.3,
                  min_matches=2, precursor_tol_mass=2000.0)
        monkeypatch.setenv("FALCON_TPU_KNN_CERTIFIED", "0")
        monkeypatch.setenv("FALCON_TPU_MAX_NEIGHBORS", "1024")
        monkeypatch.setenv("FALCON_TPU_WIDEN_PASS_CAP", "4")
    elif case == "device_blocks":
        monkeypatch.setenv("FALCON_TPU_DEVICE_BLOCK_CAP", "64")
    if case.endswith("_large"):
        monkeypatch.setattr(ann_engine, "LINKAGE_GROUP_MAX", 4)
        monkeypatch.setenv("FALCON_TPU_LINKAGE_GROUP_MAX", "4")
    jax_scans = []
    scan = jax_engine.knn_banded
    monkeypatch.setattr(jax_engine, "knn_banded",
                        lambda *a, **k: jax_scans.append(1) or scan(*a, **k))
    with caplog.at_level("INFO", logger="falcon_tpu"):
        labels, medoids = _generate(ann_engine, dataset, **kw)
    ref_labels, ref_medoids = _generate(jax_engine, dataset, **kw)
    np.testing.assert_array_equal(labels, ref_labels)
    np.testing.assert_array_equal(medoids, ref_medoids)
    assert len(np.unique(labels)) < len(labels)
    if case == "jax_multipass":
        assert len(jax_scans) > 1
    if case == "widened":
        assert "widening the retrieval width" in caplog.text
    if case == "device_blocks":
        assert "device blocks (cap 64)" in caplog.text


def test_default_ann_engine_keeps_survivors_behind_rt_holes(tmp_path):
    # tests/test_ann.py's RT-holes regression: q's only true neighbour s1
    # sits behind 20 RT-violating candidates with higher bounds; sizing the
    # kept width from the survivor count would cut s1 before the rerank.
    rng = np.random.default_rng(0)
    common_mz = np.sort(rng.uniform(300.0, 1200.0, 20)).astype(np.float32)

    def mk(c, unique_lo, rt, ident):
        mz = np.concatenate([common_mz,
                             np.float32([unique_lo, unique_lo + 7.0])])
        inten = np.concatenate([
            np.full(20, np.sqrt(c / 20), np.float32),
            np.full(2, np.sqrt((1 - c) / 2), np.float32)])
        order = np.argsort(mz)
        return dict(identifier=ident, precursor_mz=500.0,
                    precursor_charge=2, retention_time=float(rt),
                    mz=mz[order], intensity=inten[order],
                    filename="synthetic.mgf")

    rows = [mk(0.999, 130.0, 0.0, "q"), mk(0.78, 140.0, 5.0, "s1")]
    rows += [mk(0.80, 160.0 + 9.0 * i, 5000.0, f"decoy{i}")
             for i in range(20)]
    store = SpectrumStore(str(tmp_path / "spectra"))
    writer = store.writer()
    writer.add_many(rows)
    writer.close()
    kw = dict(eps=0.13, rt_tol=10.0, low_dim=1600, ann_index="auto")
    labels, medoids = _generate(ann_engine, store.dataset(2), **kw)
    ref_labels, ref_medoids = _generate(jax_engine, store.dataset(2), **kw)
    np.testing.assert_array_equal(labels, ref_labels)
    np.testing.assert_array_equal(medoids, ref_medoids)
    assert labels[0] == labels[1] and not (labels[2:] == labels[0]).any()


@pytest.mark.parametrize("n", [1, 2, 3])
def test_default_ann_engine_tiny_buckets(rows, n, tmp_path):
    # k_final = min(n_neighbors, n - 1): one neighbour for two spectra,
    # and a bucket of one spectrum never reaches the scan.  Rows of one
    # cluster, so the pair is within tolerance and eps.
    order = np.argsort([r["precursor_mz"] for r in rows], kind="stable")
    picked = [rows[i] for i in order[:n]]
    store = SpectrumStore(str(tmp_path / "spectra"))
    writer = store.writer()
    writer.add_many(picked)
    writer.close()
    kw = dict(ann_index="auto", eps=0.9, precursor_tol_mass=2000.0)
    labels, medoids = _generate(ann_engine, store.dataset(2), **kw)
    ref_labels, ref_medoids = _generate(jax_engine, store.dataset(2), **kw)
    np.testing.assert_array_equal(labels, ref_labels)
    np.testing.assert_array_equal(medoids, ref_medoids)
    assert len(labels) == n
