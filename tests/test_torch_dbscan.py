"""The port's dbscan mode and ``--rerank off`` against the JAX package's, on
the CPU: the two medoid scores (``ops/medoids.py``) and the ann engine's
labels and medoids.

- ``sparse_medoid_scores_plain`` against ``_sparse_exact_medoid_scores``:
  mutual and one-way edges, -1 slots, the spill segment, padded rows, n not
  a power of two, several 1,024-row chunks, list widths that XLA sums in
  one window and in several, and duplicate rows (exact ties).  Within 1e-6
  on every row the medoid search reads; the sums take XLA's CPU order, so
  they agree bit for bit here.
- ``hashed_medoid_scores_plain`` against ``_medoid_scores``: within 1e-6 on
  every row the medoid search reads (the spill segment is skipped); XLA's
  CPU dot agrees with one fused multiply-add per dimension to an ulp.
- ``generate_clusters`` labels and medoids identical to the JAX package's
  in dbscan mode (``auto``, ``brute`` and ``exact`` index, ``min_samples``
  2 and 3, with ``rt_tol``, with ``min_matches > 0``, in device blocks) and
  under ``--rerank off`` (linkage and dbscan).  The corpus holds no
  duplicate spectra: their medoid scores tie up to the last bit of the
  exact similarities, which agree with the JAX package's to 1e-6, not bit
  for bit, so a tie there may break the other way (duplicates are covered
  by the score tests above, on the same inputs).  Inputs are made from
  seeds with numpy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from falcon_tpu.cluster import ann_engine as jax_engine
from falcon_tpu.preprocess import process_spectrum
from falcon_tpu.simulate import make_clustered_spectra
from falcon_tpu.store.store import SpectrumStore
from falcon_tpu_torch.cluster import ann_engine
from falcon_tpu_torch.ops import medoids
from torch_cases import medoid_hub_lists, medoid_lists, tiers_reached

TOL = 0.05
ATOL = 1e-6


@pytest.mark.parametrize("n,n_pad,k", [(300, 512, 16), (300, 512, 48),
                                       (1500, 2048, 64), (700, 1024, 37)],
                         ids=["k16", "k48_windows", "k64_two_chunks",
                              "k37_odd"])
def test_sparse_medoid_scores_match_jax(n, n_pad, k):
    sims, neigh, seg, n_seg = medoid_lists(n, n_pad, k, seed=n + k)
    ref = np.asarray(jax_engine._sparse_exact_medoid_scores(
        jnp.asarray(sims), jnp.asarray(neigh.astype(np.int32)), seg, n_seg))
    seg_pad = np.full(n_pad, n_seg - 1, np.int32)
    seg_pad[:n] = seg
    args = (torch.from_numpy(sims), torch.from_numpy(neigh),
            torch.from_numpy(seg_pad), n_seg - 1)
    before = medoids.sparse_medoid_scores.launches
    got = medoids.sparse_medoid_scores(*args)
    assert medoids.sparse_medoid_scores.launches == before
    assert torch.equal(got, medoids.sparse_medoid_scores_plain(*args))
    got = got[:n].numpy()
    read = seg != n_seg - 1
    np.testing.assert_allclose(got[read], ref[read], atol=ATOL, rtol=0)
    np.testing.assert_array_equal(got[read], ref[read])
    assert (got[read] > 0).mean() > 0.15


@pytest.mark.parametrize("k", [16, 24])
def test_sparse_medoid_scores_hub_matches_jax(k):
    # Targets whose in-edges the kernel orders with a warp (80) and with a
    # block of its own (1,281, from two 1,024-row chunks around the hub's
    # own row sum).
    n, n_pad = 1500, 2048
    sims, neigh, seg, n_seg = medoid_hub_lists(n, n_pad, k, seed=k)
    ref = np.asarray(jax_engine._sparse_exact_medoid_scores(
        jnp.asarray(sims), jnp.asarray(neigh.astype(np.int32)), seg, n_seg))
    seg_pad = np.full(n_pad, n_seg - 1, np.int32)
    seg_pad[:n] = seg
    args = (torch.from_numpy(sims), torch.from_numpy(neigh),
            torch.from_numpy(seg_pad), n_seg - 1)
    got = medoids.sparse_medoid_scores(*args).numpy()[:n]
    read = seg != n_seg - 1
    np.testing.assert_array_equal(got[read], ref[read])
    in_deg = np.bincount(neigh[neigh >= 0], minlength=n_pad)
    assert in_deg[1400] > 1024 and 32 < in_deg[1450] <= 1024
    assert tiers_reached(in_deg, 1024) == (True, True, True)


@pytest.mark.parametrize("n,n_pad", [(300, 512), (700, 1024)])
def test_hashed_medoid_scores_match_jax(n, n_pad):
    _, _, seg, n_seg = medoid_lists(n, n_pad, 8, seed=n)
    rng = np.random.default_rng(n)
    v = rng.random((n_pad, 512)) * (rng.random((n_pad, 512)) < 0.1)
    v = (v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-12)
         ).astype(np.float32)
    v[n:] = 0.0  # padded rows: zero vectors in segment 0 in JAX
    v[:10] = v[10:20]  # duplicates
    ref = np.asarray(jax_engine._medoid_scores(jnp.asarray(v), seg, n_seg))
    args = (torch.from_numpy(v), torch.from_numpy(seg), n_seg - 1)
    before = medoids.hashed_medoid_scores.launches
    got = medoids.hashed_medoid_scores(*args)
    assert medoids.hashed_medoid_scores.launches == before
    assert torch.equal(got, medoids.hashed_medoid_scores_plain(*args))
    got = got.numpy()
    read = seg != n_seg - 1
    np.testing.assert_allclose(got[read], ref[read], atol=ATOL, rtol=0)
    np.testing.assert_array_equal(got[:10], got[10:20])
    assert (got[~read] == 0).all()


def test_xla_row_sums_and_fma_orders():
    # The row sums take XLA's windows (centred padding), and _fma rounds
    # once: against Python's exact fractions on random float32 inputs.
    from fractions import Fraction

    rng = np.random.default_rng(4)
    w = rng.random((8, 100)).astype(np.float32) * 1e3
    got = medoids.xla_row_sums(torch.from_numpy(w)).numpy()
    low = (128 - 100) // 2
    padded = np.pad(w, ((0, 0), (low, 28 - low)))
    want = np.zeros(8, np.float32)
    for m in range(4):
        part = np.zeros(8, np.float32)
        for j in range(32 * m, 32 * m + 32):
            part = (part + padded[:, j]).astype(np.float32)
        want = (want + part).astype(np.float32)
    np.testing.assert_array_equal(got, want)
    a, b, c = (rng.random(2000).astype(np.float32) * s for s in (1, 10, 100))
    got = medoids._fma(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    for i in range(len(a)):
        exact = (Fraction(float(a[i])) * Fraction(float(b[i]))
                 + Fraction(float(c[i])))
        lo, hi = np.nextafter(got[i], -np.inf), np.nextafter(got[i], np.inf)
        err = abs(Fraction(float(got[i])) - exact)
        assert err <= abs(Fraction(float(lo)) - exact)
        assert err <= abs(Fraction(float(hi)) - exact)


def test_medoid_wrappers_reject_bad_inputs():
    sims, neigh, seg, n_seg = medoid_lists(40, 512, 8, seed=1)
    seg_pad = torch.full((512,), n_seg - 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="neigh"):
        medoids.sparse_medoid_scores(torch.from_numpy(sims),
                                     torch.from_numpy(neigh).int(), seg_pad,
                                     n_seg - 1)
    with pytest.raises(ValueError, match="n_pad"):
        medoids.sparse_medoid_scores(torch.from_numpy(sims)[:40],
                                     torch.from_numpy(neigh)[:40], seg_pad,
                                     n_seg - 1)
    with pytest.raises(ValueError, match="int32"):
        medoids.hashed_medoid_scores(torch.zeros((40, 128)),
                                     torch.zeros(40, dtype=torch.int64), 3)


def _rows():
    spectra, _ = make_clustered_spectra(
        n_clusters=20, cluster_size=6, n_noise=40, seed=33, charges=(2,),
        precursor_mz_range=(600.0, 601.0))
    rows = [process_spectrum(s, 5, 250, 101.0, 1500.0, 1.5, 0.01, 50, None)
            for s in spectra]
    return [r for r in rows if r is not None]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    store = SpectrumStore(str(tmp_path_factory.mktemp("dbscan_spectra")))
    writer = store.writer(batch_size=37)
    writer.add_many(_rows())
    writer.close()
    return store.dataset(2)


def _generate(module, dataset, **kw):
    args = dict(eps=0.1, min_samples=2, min_matches=0,
                precursor_tol_mass=20.0, precursor_tol_mode="ppm",
                rt_tol=None, fragment_tol=TOL, batch_size=2**15,
                ann_index="auto", cluster_method="dbscan",
                linkage="complete")
    args.update(kw)
    if module is ann_engine:
        return ann_engine.generate_clusters(dataset, device="cpu", **args)
    return jax_engine.generate_clusters(dataset, **args)


CASES = {
    "auto": {},
    "auto_min_samples_3": dict(min_samples=3),
    "brute": dict(ann_index="brute"),
    "exact": dict(ann_index="exact"),
    "exact_min_samples_3": dict(ann_index="exact", min_samples=3),
    "auto_rt": dict(rt_tol=600.0, eps=0.2),
    "exact_rt_min_matches": dict(ann_index="exact", rt_tol=600.0,
                                 min_matches=3),
    "auto_min_matches": dict(min_matches=4, eps=0.2),
    "auto_device_blocks": dict(eps=0.2),
    "exact_device_blocks": dict(ann_index="exact"),
    "rerank_off_linkage": dict(rerank="off", cluster_method="linkage"),
    "rerank_off_linkage_average": dict(rerank="off", cluster_method="linkage",
                                       linkage="average", eps=0.2),
    "rerank_off_dbscan": dict(rerank="off"),
    "rerank_off_brute_min_samples_3_rt": dict(
        rerank="off", ann_index="brute", min_samples=3, rt_tol=600.0,
        eps=0.2),
    "rerank_off_device_blocks": dict(rerank="off", eps=0.2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_matches_jax(dataset, case, monkeypatch, caplog):
    if case.endswith("device_blocks"):
        monkeypatch.setenv("FALCON_TPU_DEVICE_BLOCK_CAP", "64")
    if case == "rerank_off_linkage_average":
        # Components over 4 spectra: K1 under average linkage.
        monkeypatch.setattr(ann_engine, "LINKAGE_GROUP_MAX", 4)
        monkeypatch.setenv("FALCON_TPU_LINKAGE_GROUP_MAX", "4")
    kw = CASES[case]
    with caplog.at_level("INFO", logger="falcon_tpu"):
        labels, medoid_rows = _generate(ann_engine, dataset, **kw)
    ref_labels, ref_medoids = _generate(jax_engine, dataset, **kw)
    np.testing.assert_array_equal(labels, ref_labels)
    np.testing.assert_array_equal(medoid_rows, ref_medoids)
    assert len(np.unique(labels)) < len(labels)  # something clustered
    assert len(medoid_rows) == len(np.unique(labels))
    if case.endswith("device_blocks"):
        assert "device blocks (cap 64)" in caplog.text


def test_engine_medoids_route(dataset, monkeypatch):
    # dbscan mode takes its medoids from the exact lists, except under
    # --rerank off, which takes them from the hashed vectors; linkage mode
    # takes neither.
    calls = []
    for name in ("sparse_medoid_scores", "hashed_medoid_scores"):
        def counted(*a, _f=getattr(medoids, name), _n=name, **k):
            calls.append(_n)
            return _f(*a, **k)
        monkeypatch.setattr(medoids, name, counted)
    _generate(ann_engine, dataset)
    _generate(ann_engine, dataset, ann_index="exact")
    _generate(ann_engine, dataset, rerank="off")
    _generate(ann_engine, dataset, rerank="off", cluster_method="linkage")
    assert calls == ["sparse_medoid_scores", "sparse_medoid_scores",
                     "hashed_medoid_scores"]
