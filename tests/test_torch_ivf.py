"""The port's IVF index (``falcon_tpu_torch/ops/ivf.py``) and the ann
engine's ``--ann_index ivf`` against the JAX package's, on the CPU.

- k-means: one Lloyd step and a 10-step fit within 1e-6 of the JAX
  package's centroids (its one-hot product sums in XLA's GEMM order, the
  port in row order), and the plain update (IVF.2) bit for bit the
  row-order segment sum.
- ``_assign_topk``: the same 8 choices for every row, on ``tests/
  test_ivf.py``'s vectors and on ~4,000 normalised spread vectors of the
  port's ``SpectrumHasher``.
- Placement and layout: with the JAX package's centroids given to the port,
  and without, the same ``order``, ``offsets``, slab width, m/z and row
  layouts, and the same slabs.
- The probe scan (``_chunk_scan`` on ``probe_scan_plain``) against the JAX
  package's ``_chunk_scan`` on the JAX index's own layout, in bfloat16 and
  float32, Da and ppm, finite and infinite tolerance: scores within 2e-5
  (bf16: the products are exact, the float32 sums taken in another order)
  and 1e-5 (float32), slots identical wherever a score is further than
  that from its neighbours in the list.
- The nine behaviours of ``tests/test_ivf.py`` on the port.
- ``generate_clusters(ann_index="ivf")``: labels and medoids identical to
  the JAX package's in linkage and dbscan mode, with and without the
  exact rerank, exhaustive and pruned probing.

Inputs are made from seeds with numpy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from falcon_tpu.cluster import ann_engine as jax_engine
from falcon_tpu.ops import ivf as J
from falcon_tpu.preprocess import process_spectrum
from falcon_tpu.simulate import make_clustered_spectra
from falcon_tpu.store.store import SpectrumStore
from falcon_tpu_torch.cluster import ann_engine
from falcon_tpu_torch.ops import ivf as T
from falcon_tpu_torch.ops.medoids import segment_sums_plain
from falcon_tpu_torch.ops.vectorize import SpectrumHasher, normalize_rows
from falcon_tpu_torch.preprocess import get_dim
from falcon_tpu_torch.store.store import padded_peaks

TOL = 0.05
CENTROID_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    # The plain versions run thousands of small ops (one emulated fused
    # multiply-add per dimension); beside other test processes on the same
    # cores, torch's intra-op threads mostly wait on each other.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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
def clustered_vectors():
    return _clustered()


@pytest.fixture(scope="module")
def spread_block():
    """~4,000 normalised spread vectors of one charge's spectra, sorted by
    precursor m/z, from the port's hasher at the CLI's defaults."""
    spectra, _ = make_clustered_spectra(n_clusters=250, cluster_size=10,
                                        n_noise=1600, seed=12, charges=(2,))
    rows = [process_spectrum(s, 5, 250, 101.0, 1500.0, 1.5, 0.01, 50, None)
            for s in spectra]
    rows = sorted((r for r in rows if r is not None),
                  key=lambda r: r["precursor_mz"])
    offsets = np.zeros(len(rows) + 1, np.int64)
    offsets[1:] = np.cumsum([len(r["mz"]) for r in rows])
    mz, intensity, _ = padded_peaks(
        offsets, np.concatenate([r["mz"] for r in rows]),
        np.concatenate([r["intensity"] for r in rows]), 64)
    _, mz_min, mz_max = get_dim(101.0, 1500.0, TOL)
    spread = SpectrumHasher(mz_min, mz_max, TOL).vectorize(
        torch.from_numpy(mz), torch.from_numpy(intensity), norm=False,
        spread=True)
    return (normalize_rows(spread).numpy(),
            np.asarray([r["precursor_mz"] for r in rows]))


def _init(vectors, n_lists, seed=42):
    rows = np.random.default_rng(seed).choice(len(vectors), n_lists,
                                              replace=False)
    return vectors[rows]


@pytest.mark.parametrize("source,n_lists,n_iters", [
    ("clustered", 32, 1), ("clustered", 32, 10), ("spread", 64, 1),
    ("spread", 64, 10)])
def test_kmeans_matches_jax(clustered_vectors, spread_block, source,
                            n_lists, n_iters):
    vecs = (clustered_vectors if source == "clustered" else spread_block)[0]
    init = _init(vecs, n_lists)
    want = np.asarray(J._kmeans_fit(jnp.asarray(vecs), jnp.asarray(init),
                                    n_lists, n_iters))
    got = T._kmeans_fit(torch.from_numpy(vecs), torch.from_numpy(init),
                        n_lists, n_iters).numpy()
    np.testing.assert_allclose(got, want, atol=CENTROID_ATOL, rtol=0)
    # The assignments that decide the next step agree.
    np.testing.assert_array_equal(
        np.asarray(J._assign(jnp.asarray(vecs), jnp.asarray(want))),
        T._assign(torch.from_numpy(vecs), torch.from_numpy(got)).numpy())


def test_kmeans_update_plain_is_the_row_order_sum(spread_block):
    vecs = torch.from_numpy(spread_block[0])
    rng = np.random.default_rng(5)
    n_lists = 64
    # List 3 empty: it keeps its old centroid.
    assign = rng.integers(0, n_lists, len(vecs)).astype(np.int32)
    assign[assign == 3] = 4
    centroids = torch.from_numpy(_init(spread_block[0], n_lists))
    assign_t = torch.from_numpy(assign)
    before = T.kmeans_update.launches
    got = T.kmeans_update(vecs, assign_t, centroids)
    assert T.kmeans_update.launches == before  # CPU tensors: plain version
    assert torch.equal(got, T.kmeans_update_plain(vecs, assign_t,
                                                  centroids))
    sums = torch.zeros((n_lists, vecs.shape[1]))
    for row in range(len(vecs)):  # one row after another, in order
        sums[assign[row]] = sums[assign[row]] + vecs[row]
    assert torch.equal(segment_sums_plain(vecs, assign_t, n_lists), sums)
    sums[3] = centroids[3]
    assert torch.equal(got, normalize_rows(sums))
    one_hot = torch.nn.functional.one_hot(assign_t.long(), n_lists).float()
    np.testing.assert_allclose(got.numpy(), normalize_rows(
        torch.where(one_hot.sum(0)[:, None] > 0, one_hot.t() @ vecs,
                    centroids)).numpy(), atol=CENTROID_ATOL, rtol=0)


@pytest.mark.parametrize("source", ["clustered", "spread"])
def test_assign_topk_matches_jax(clustered_vectors, spread_block, source):
    vecs = (clustered_vectors if source == "clustered" else spread_block)[0]
    n_lists = 32 if source == "clustered" else 64
    centroids = np.asarray(J._kmeans_fit(
        jnp.asarray(vecs), jnp.asarray(_init(vecs, n_lists)), n_lists, 10))
    want = np.asarray(J._assign_topk(jnp.asarray(vecs),
                                     jnp.asarray(centroids), 8))
    got = T._assign_topk(torch.from_numpy(vecs), torch.from_numpy(centroids),
                         8).numpy()
    np.testing.assert_array_equal(got, want)


def _same_layout(got, want, slabs=True):
    assert got.n_lists == want.n_lists and got._lb == want._lb
    for name in ("order", "offsets", "mzs", "rows", "_row3d_host"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))
    np.testing.assert_array_equal(got._mz3d.numpy(), np.asarray(want._mz3d))
    np.testing.assert_array_equal(got._row3d.numpy(),
                                  np.asarray(want._row3d))
    if slabs:
        for mine, theirs in ((got._corpus3d, want._corpus3d),
                             (got._query3d, want._query3d)):
            assert (mine is None) == (theirs is None)
            if mine is not None:
                np.testing.assert_array_equal(
                    mine.float().numpy(),
                    np.asarray(theirs.astype(jnp.float32)))


@pytest.mark.parametrize("inject", [True, False],
                         ids=["jax_centroids", "own_centroids"])
@pytest.mark.parametrize("source", ["clustered", "spread"])
def test_placement_and_layout_match_jax(clustered_vectors, spread_block,
                                        monkeypatch, inject, source):
    vecs, mzs = clustered_vectors if source == "clustered" else spread_block
    kw = dict(n_lists=32 if source == "clustered" else None, seed=42)
    if source == "spread":
        kw.update(coarse_vectors=vecs, rank_vectors=1.5 * vecs)
    want = J.IVFIndex(vecs, mzs, **kw)
    if inject:
        monkeypatch.setattr(T, "_kmeans_fit", lambda *a: torch.from_numpy(
            want.centroids))
    got = T.IVFIndex(vecs, mzs, device="cpu", **kw)
    if inject:
        np.testing.assert_array_equal(got.centroids, want.centroids)
    else:
        np.testing.assert_allclose(got.centroids, want.centroids,
                                   atol=CENTROID_ATOL, rtol=0)
    _same_layout(got, want)
    np.testing.assert_array_equal(got._probe_ids(8), want._probe_ids(8))


def _separated(scores, tol):
    """Entries further than ``tol`` from both neighbours in their row."""
    gap = np.abs(np.diff(scores, axis=-1)) > tol
    far = np.ones(scores.shape, bool)
    far[..., 1:] &= gap
    far[..., :-1] &= gap
    return far


@pytest.mark.parametrize("precise", [False, True], ids=["bf16", "f32"])
@pytest.mark.parametrize("tol_mode,tol_mass", [
    ("Da", 20.0), ("ppm", 20000.0), ("Da", np.inf), ("ppm", np.inf)])
def test_chunk_scan_matches_jax(clustered_vectors, tol_mode, tol_mass,
                                precise):
    vecs, mzs = clustered_vectors
    index = J.IVFIndex(vecs, mzs, n_lists=32, seed=42, precise=precise)
    n_probe, k, lb = 4, 24, index._lb
    chunk = 8
    probe_ids = index._probe_ids(n_probe)
    args = (index._corpus3d, index._mz3d, index._row3d, index._corpus3d,
            index._mz3d, index._row3d)
    want_s, want_i = (np.asarray(a) for a in J._chunk_scan(
        *args, jnp.asarray(probe_ids), jnp.float32(tol_mass), k,
        tol_mode == "Da", chunk, lb, lb, n_probe, precise))
    t_args = [torch.from_numpy(np.asarray(
        a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a))
        for a in args]
    if not precise:
        t_args[0] = t_args[3] = t_args[0].bfloat16()
    before = T.probe_topk.launches
    got_s, got_i = (a.numpy() for a in T._chunk_scan(
        *t_args, torch.from_numpy(probe_ids), tol_mass, k, tol_mode == "Da",
        chunk, lb, lb, n_probe, precise))
    assert T.probe_topk.launches == before  # CPU tensors: plain version
    real = index._row3d_host >= 0  # padded query slots: see probe_topk
    atol = 1e-5 if precise else 2e-5
    np.testing.assert_allclose(got_s[real], want_s[real], atol=atol, rtol=0)
    masked = want_s[real] == float(J.NEG)
    assert (~masked).sum() > 2 * real.sum()  # pairs scored
    assert ((got_s[real] == T.NEG) == masked).all()
    assert ((got_i[real] == -1) == masked).all()
    sep = _separated(want_s[real], 2 * atol) & ~masked
    assert sep.sum() > real.sum()
    np.testing.assert_array_equal(got_i[real][sep], want_i[real][sep])


def test_probe_scan_plain_masks(clustered_vectors):
    # Every masked pair scores NEG and every kept one its float32 dot; a
    # padded query slot is masked at tol = inf too.
    vecs, mzs = clustered_vectors
    index = T.IVFIndex(vecs, mzs, n_lists=16, seed=42, precise=True,
                       device="cpu")
    probe_ids = torch.from_numpy(index._probe_ids(3))
    layout = (index._corpus3d, index._mz3d, index._row3d)
    lb = index._lb
    for tol, da in ((0.5, True), (300.0, False), (np.inf, True)):
        out = T.probe_scan_plain(*layout, *layout, probe_ids, tol, da, 4,
                                 4).view(4, lb, 3, lb)
        for lst in range(4, 8):
            for p in range(3):
                s = int(probe_ids[lst, p])
                qm = index._mz3d[lst][:, None].double()
                sm = index._mz3d[s][None, :].double()
                mass = (qm - sm).abs() if da else ((qm - sm) / sm * 1e6).abs()
                keep = ((mass <= tol) & torch.isfinite(qm) & torch.isfinite(sm)
                        & (index._row3d[lst][:, None] != index._row3d[s]))
                dots = index._corpus3d[lst] @ index._corpus3d[s].t()
                got = out[lst - 4, :, p]
                assert (got[~keep] == T.NEG).all()
                np.testing.assert_allclose(got[keep].numpy(),
                                           dots[keep].numpy(), atol=1e-5)


def _topk_oracle(index, q3d, probe_ids, tol, da, k, c0, chunk):
    """Each row's k best positions by NumPy's lexsort of (score descending,
    position ascending) over the plain scan's scores, and their slots."""
    lb = index._lb
    layout = (index._mz3d, index._row3d, index._corpus3d, index._mz3d,
              index._row3d)
    scores = T.probe_scan_plain(q3d, *layout, probe_ids, tol, da, c0,
                                chunk).view(chunk * lb, -1).numpy()
    pos = np.arange(scores.shape[1])
    order = np.stack([np.lexsort((pos, -row))[:k] for row in scores])
    top = np.take_along_axis(scores, order, 1)
    lists = np.repeat(np.arange(c0, c0 + chunk), lb)[:, None]
    slot = probe_ids.numpy()[lists, order // lb] * lb + order % lb
    return top, np.where(top > T.NEG, slot, -1), order


def _ivf_cpu(vecs, mzs, precise=True):
    return T.IVFIndex(vecs, mzs, n_lists=16, seed=42, precise=precise,
                      device="cpu")


@pytest.mark.parametrize("k", ["1", "24", "all", "above_band"])
def test_probe_topk_on_cpu_is_the_plain_top_k(clustered_vectors, k):
    # CPU tensors take the plain version (no launch), which is the stable
    # top-k of the plain scan's scores with each position's slot.
    vecs, mzs = clustered_vectors
    index = _ivf_cpu(vecs, mzs)
    n_probe, lb, c0, chunk = 3, index._lb, 4, 4
    probe_ids = torch.from_numpy(index._probe_ids(n_probe))
    tol, da = 2.0, True
    layout = (index._corpus3d, index._mz3d, index._row3d)
    in_band = (T.probe_scan_plain(*layout, *layout, probe_ids, tol, da, c0,
                                  chunk) > T.NEG).sum(-1)
    k = {"1": 1, "24": 24, "all": n_probe * lb,
         "above_band": int(in_band.max()) + 5}[k]
    before = T.probe_topk.launches
    got_s, got_i = T.probe_topk(*layout, *layout, probe_ids, tol, da, k, c0,
                                chunk)
    assert T.probe_topk.launches == before
    assert got_s.shape == got_i.shape == (chunk, lb, k)
    assert got_s.dtype == torch.float32 and got_i.dtype == torch.int32
    want_s, want_i, _ = _topk_oracle(index, index._corpus3d, probe_ids, tol,
                                     da, k, c0, chunk)
    np.testing.assert_array_equal(got_s.view(chunk * lb, k).numpy(), want_s)
    np.testing.assert_array_equal(got_i.view(chunk * lb, k).numpy(), want_i)
    plain = T.probe_topk_plain(*layout, *layout, probe_ids, tol, da, k, c0,
                               chunk)
    assert torch.equal(got_s, plain[0]) and torch.equal(got_i, plain[1])
    # Rows with fewer than k pairs in band end in NEG and -1.
    short = (in_band < k).view(-1).numpy()
    assert short.any()
    tail = got_s.view(chunk * lb, k)[torch.from_numpy(short), -1]
    assert (tail == T.NEG).all()


def test_probe_topk_ties_go_to_the_lower_position(clustered_vectors):
    # A layout of exact duplicate rows: each score is held by several
    # pairs, and they are kept in ascending position.
    vecs, mzs = clustered_vectors
    dup = np.repeat(vecs[::4], 4, axis=0)[:len(vecs)]
    index = _ivf_cpu(dup, mzs, precise=False)
    n_probe, lb, chunk = 4, index._lb, 8
    probe_ids = torch.from_numpy(index._probe_ids(n_probe))
    layout = (index._corpus3d, index._mz3d, index._row3d)
    ties = 0
    for c0 in range(0, index.n_lists, chunk):
        got_s, got_i = T.probe_topk(*layout, *layout, probe_ids, np.inf,
                                    True, 40, c0, chunk)
        want_s, want_i, pos = _topk_oracle(index, index._corpus3d, probe_ids,
                                           np.inf, True, 40, c0, chunk)
        np.testing.assert_array_equal(got_s.view(-1, 40).numpy(), want_s)
        np.testing.assert_array_equal(got_i.view(-1, 40).numpy(), want_i)
        same = want_s[:, 1:] == want_s[:, :-1]
        assert (pos[:, 1:][same] > pos[:, :-1][same]).all()
        ties += int((same & (want_s[:, 1:] > T.NEG)).sum())
    assert ties > 1000


@pytest.mark.parametrize("precise", [False, True], ids=["bf16", "f32"])
def test_self_search_is_search_on_the_device(clustered_vectors, precise):
    # self_search maps slots to rows and the layout to row order by
    # gathers; the result is the host mapping of the chunk scan's lists,
    # and search's for the index's own tensor.
    vecs, mzs = clustered_vectors
    vt = torch.from_numpy(vecs)
    index = T.IVFIndex(vt, mzs, n_lists=32, seed=42, precise=precise,
                       rank_vectors=1.5 * vt)
    n, k, n_probe = len(mzs), 12, 8
    s, i = index.self_search(k, n_probe=n_probe, tol_mass=20000.0,
                             tol_mode="ppm", precise=precise)
    assert s.shape == i.shape == (n, k)
    assert s.dtype == torch.float32 and i.dtype == torch.int32
    scores, slots = index._scan(index._query3d, index._mz3d, index._row3d,
                                index._lb, k, n_probe, 20000.0, "ppm",
                                precise)
    rows_flat = index._row3d_host.reshape(-1)
    slots_h = slots.reshape(len(rows_flat), k).numpy()
    want_s = np.empty((n, k), np.float32)
    want_i = np.empty((n, k), np.int32)
    real = rows_flat >= 0
    want_s[rows_flat[real]] = scores.reshape(len(rows_flat), k).numpy()[real]
    want_i[rows_flat[real]] = np.where(slots_h >= 0, rows_flat[slots_h],
                                       -1)[real]
    np.testing.assert_array_equal(s.numpy(), want_s)
    np.testing.assert_array_equal(i.numpy(), want_i)
    assert (i >= 0).sum() > n  # neighbours found
    got = index.search(vt, mzs, np.arange(n, dtype=np.int32), k,
                       n_probe=n_probe, tol_mass=20000.0, tol_mode="ppm",
                       precise=precise)
    np.testing.assert_array_equal(got[0], want_s)
    np.testing.assert_array_equal(got[1], want_i)
    # Above n_probe * lb the lists are padded with -2 / -1.
    wide = index.self_search(n_probe * index._lb + 3, n_probe=n_probe)
    assert (wide[0][:, -3:] == T.NEG).all() and (wide[1][:, -3:] == -1).all()


def test_scan_chunk_bounds_the_key_segments():
    # 256 lists of 256 slots, 32 probes: 16 lists of 64-bit key segments
    # in 256 MB; 1,024-slot lists: one; a small index: all its lists.
    assert T.scan_chunk(256, 256, 32, 256) == 16
    assert T.scan_chunk(512, 1024, 32, 1024) == 1
    assert T.scan_chunk(16, 128, 4, 128) == 16
    for n_lists, lb, n_probe in ((256, 256, 32), (64, 128, 8)):
        chunk = T.scan_chunk(n_lists, lb, n_probe, lb)
        assert chunk * lb * n_probe * lb * 8 <= 256 * 2**20
        assert n_lists % chunk == 0


def behaviour_deterministic(vecs, mzs):
    a = T.IVFIndex(vecs, mzs, n_lists=32, seed=42, device="cpu")
    b = T.IVFIndex(vecs, mzs, n_lists=32, seed=42, device="cpu")
    np.testing.assert_array_equal(a.centroids, b.centroids)
    np.testing.assert_array_equal(a.order, b.order)


def _exact(vecs, q, row):
    exact = vecs[q] @ vecs.T
    exact[row] = -2
    return exact


def behaviour_recall(vecs, mzs):
    index = T.IVFIndex(vecs, mzs, n_lists=32, seed=42, device="cpu")
    rng = np.random.default_rng(1)
    q = rng.choice(len(vecs), 64, replace=False)
    k = 10
    _, idx = index.search(vecs[q], mzs[q], q.astype(np.int32), k, n_probe=8,
                          tol_mass=np.inf, tol_mode="Da")
    hits = sum(len(set(np.argsort(-_exact(vecs, row, row))[:k].tolist())
                   & set(int(x) for x in idx[qi] if x >= 0))
               for qi, row in enumerate(q))
    assert hits / (k * len(q)) >= 0.9


def behaviour_full_probe_is_exact(vecs, mzs):
    index = T.IVFIndex(vecs, mzs, n_lists=32, seed=42, device="cpu")
    q = np.random.default_rng(1).choice(len(vecs), 64, replace=False)
    sims, _ = index.search(vecs[q], mzs[q], q.astype(np.int32), 10,
                           n_probe=32, tol_mass=np.inf, tol_mode="Da")
    for qi, row in enumerate(q):
        # bfloat16 operands: compare at bf16 resolution.
        np.testing.assert_allclose(
            np.sort(sims[qi])[::-1],
            np.sort(_exact(vecs, row, row))[::-1][:10], atol=4e-3)


def behaviour_precise(vecs, mzs):
    index = T.IVFIndex(vecs, mzs, n_lists=32, seed=42, precise=True,
                       device="cpu")
    q = np.random.default_rng(2).choice(len(vecs), 32, replace=False)
    sims, _ = index.search(vecs[q], mzs[q], q.astype(np.int32), 5,
                           n_probe=32, tol_mass=np.inf, tol_mode="Da",
                           precise=True)
    for qi, row in enumerate(q):
        np.testing.assert_allclose(
            np.sort(sims[qi])[::-1],
            np.sort(_exact(vecs, row, row))[::-1][:5], atol=2e-5)


def behaviour_tolerance_mask(vecs, mzs):
    index = T.IVFIndex(vecs, mzs, n_lists=16, seed=42, device="cpu")
    q = np.arange(10)
    sims, idx = index.search(vecs[q], mzs[q], q.astype(np.int32), 5,
                             n_probe=16, tol_mass=0.5, tol_mode="Da")
    for qi in range(len(q)):
        for j in idx[qi]:
            if j >= 0:
                assert abs(mzs[j] - mzs[q[qi]]) <= 0.5
                assert j != q[qi]


def behaviour_n_lists_not_a_power_of_two(vecs, mzs):
    small = T.IVFIndex(vecs[:7], mzs[:7], seed=42, device="cpu")
    assert small.n_lists in (1, 2, 4)
    _, idx = small.search(vecs[:7], mzs[:7], np.arange(7, dtype=np.int32), 3,
                          n_probe=16, tol_mass=np.inf, tol_mode="Da")
    assert idx.shape == (7, 3) and (idx[:, 0] >= 0).all()
    odd = T.IVFIndex(vecs, mzs, n_lists=20, seed=42, device="cpu")
    assert odd.n_lists == 16
    _, idx = odd.search(vecs[:8], mzs[:8], np.arange(8, dtype=np.int32), 4,
                        n_probe=16, tol_mass=np.inf, tol_mode="Da")
    assert idx.shape == (8, 4)


def behaviour_balanced_placement(vecs, mzs):
    choices = np.tile(np.array([[0, 1]]), (10, 1))
    order, counts = T._balanced_placement(choices, 4, 4)
    assert counts[0] == 4 and counts[1] == 4 and counts[2] == 2
    assert counts.sum() == 10 and counts.max() <= 4
    assert order.tolist() == list(range(10))
    rng = np.random.default_rng(3)
    n, n_lists, k, cap = 500, 8, 3, 128
    choices = np.stack([rng.permutation(n_lists)[:k] for _ in range(n)])
    order, counts = T._balanced_placement(choices, n_lists, cap)
    assigned = np.full(n, -1)
    oracle = np.zeros(n_lists, np.int64)
    for rank in range(k):
        for row in range(n):
            if assigned[row] < 0 and oracle[choices[row, rank]] < cap:
                assigned[row] = choices[row, rank]
                oracle[choices[row, rank]] += 1
    np.testing.assert_array_equal(counts, oracle)
    np.testing.assert_array_equal(order, np.argsort(assigned, kind="stable"))


def behaviour_slab_memory_bound(vecs, mzs):
    skew = np.tile(vecs[:1], (len(vecs), 1)) + 1e-4 * vecs
    skew = (skew / np.linalg.norm(skew, axis=1, keepdims=True)).astype(
        np.float32)
    index = T.IVFIndex(skew, mzs, n_lists=16, seed=42, device="cpu")
    n = len(mzs)
    assert index._lb <= T._bucket(2 * ((n + 15) // 16), 128)
    _, idx = index.search(skew, mzs, np.arange(n, dtype=np.int32), 3,
                          n_probe=16, tol_mass=np.inf, tol_mode="Da")
    assert (idx[:, 0] >= 0).all()


def behaviour_coarse_and_rank_vectors(vecs, mzs):
    n = len(vecs)
    rng = np.random.default_rng(7)
    coarse = vecs + rng.normal(0, 0.02, vecs.shape).astype(np.float32)
    coarse /= np.linalg.norm(coarse, axis=1, keepdims=True)
    rank = 1.5 * vecs
    sym = T.IVFIndex(vecs, mzs, n_lists=32, seed=42, device="cpu")
    asym = T.IVFIndex(vecs, mzs, n_lists=32, seed=42, coarse_vectors=coarse,
                      rank_vectors=rank, device="cpu")
    assert asym._query3d is not None
    rows = np.arange(n, dtype=np.int32)
    s_sym, i_sym = sym.search(vecs, mzs, rows, 10, n_probe=32)
    s_asym, i_asym = asym.search(vecs, mzs, rows, 10, n_probe=32)
    overlap = []
    for q in range(0, n, 37):
        a = set(i_sym[q][i_sym[q] >= 0].tolist())
        b = set(i_asym[q][i_asym[q] >= 0].tolist())
        if a or b:
            overlap.append(len(a & b) / max(len(a | b), 1))
    assert np.mean(overlap) > 0.8
    assert s_asym[s_asym > -1.0].max() <= 1.5 + 1e-3
    again = T.IVFIndex(vecs, mzs, n_lists=32, seed=42, coarse_vectors=coarse,
                       rank_vectors=rank, device="cpu")
    np.testing.assert_array_equal(asym.order, again.order)
    # A self-search through the index's own tensor ranks rank_q . v_c.
    vt = torch.from_numpy(vecs)
    own = T.IVFIndex(vt, mzs, n_lists=32, seed=42, coarse_vectors=coarse,
                     rank_vectors=rank)
    s_self, i_self = own.search(vt, mzs, rows, 10, n_probe=8)
    ref = J.IVFIndex(vecs, mzs, n_lists=32, seed=42, coarse_vectors=coarse,
                     rank_vectors=rank)
    ref_vt = ref._source
    s_ref, i_ref = ref.search(ref_vt, mzs, rows, 10, n_probe=8)
    np.testing.assert_allclose(s_self, s_ref, atol=2e-5, rtol=0)
    sep = _separated(s_ref, 4e-5)
    np.testing.assert_array_equal(i_self[sep], i_ref[sep])


BEHAVIOURS = {name[10:]: fn for name, fn in sorted(globals().items())
              if name.startswith("behaviour_")}


@pytest.mark.parametrize("behaviour", sorted(BEHAVIOURS))
def test_ivf_behaviours(clustered_vectors, behaviour):
    # tests/test_ivf.py's nine behaviours, on the port.
    BEHAVIOURS[behaviour](*clustered_vectors)


def test_external_queries_match_jax(clustered_vectors):
    vecs, mzs = clustered_vectors
    want = J.IVFIndex(vecs, mzs, n_lists=32, seed=42)
    got = T.IVFIndex(vecs, mzs, n_lists=32, seed=42, device="cpu")
    q = np.random.default_rng(4).choice(len(vecs), 96, replace=False)
    for kw in (dict(n_probe=8), dict(n_probe=32, tol_mass=3.0),
               dict(n_probe=4, tol_mass=4000.0, tol_mode="ppm",
                    precise=True)):
        s1, i1 = want.search(vecs[q], mzs[q], q.astype(np.int32), 12, **kw)
        s2, i2 = got.search(vecs[q], mzs[q], q.astype(np.int32), 12, **kw)
        np.testing.assert_allclose(s2, s1, atol=2e-5, rtol=0)
        sep = _separated(s1, 4e-5)
        np.testing.assert_array_equal(i2[sep], i1[sep])


def _rows():
    spectra, _ = make_clustered_spectra(
        n_clusters=20, cluster_size=6, n_noise=40, seed=33, charges=(2,),
        precursor_mz_range=(600.0, 601.0))
    rows = [process_spectrum(s, 5, 250, 101.0, 1500.0, 1.5, 0.01, 50, None)
            for s in spectra]
    return [r for r in rows if r is not None]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    store = SpectrumStore(str(tmp_path_factory.mktemp("ivf_spectra")))
    writer = store.writer(batch_size=37)
    writer.add_many(_rows())
    writer.close()
    return store.dataset(2)


def _generate(module, dataset, **kw):
    args = dict(eps=0.1, min_samples=2, min_matches=0,
                precursor_tol_mass=20.0, precursor_tol_mode="ppm",
                rt_tol=None, fragment_tol=TOL, batch_size=2**15,
                ann_index="ivf", linkage="complete")
    args.update(kw)
    if module is ann_engine:
        return ann_engine.generate_clusters(dataset, device="cpu", **args)
    return jax_engine.generate_clusters(dataset, **args)


@pytest.mark.parametrize("n_probe", [32, 4], ids=["exhaustive", "pruned"])
@pytest.mark.parametrize("rerank", ["exact", "off"])
@pytest.mark.parametrize("cluster_method", ["linkage", "dbscan"])
def test_engine_matches_jax(dataset, cluster_method, rerank, n_probe,
                            monkeypatch):
    calls = []
    search = T.IVFIndex.self_search

    def counted(self, *a, **k):
        calls.append((self.n_lists, k["n_probe"], k["precise"]))
        return search(self, *a, **k)

    monkeypatch.setattr(T.IVFIndex, "self_search", counted)
    kw = dict(cluster_method=cluster_method, rerank=rerank, n_probe=n_probe)
    labels, medoid_rows = _generate(ann_engine, dataset, **kw)
    ref_labels, ref_medoids = _generate(jax_engine, dataset, **kw)
    np.testing.assert_array_equal(labels, ref_labels)
    np.testing.assert_array_equal(medoid_rows, ref_medoids)
    assert len(np.unique(labels)) < len(labels)  # something clustered
    # n_probe reaches the index: 16 lists at this size, so 32 probes all.
    assert calls == [(16, n_probe, rerank == "off")]


@pytest.fixture(scope="module")
def rt_dataset(tmp_path_factory):
    """``dataset``'s spectra with retention times drawn from a seed."""
    rows = _rows()
    rts = np.random.default_rng(8).uniform(0.0, 100.0, len(rows))
    for row, rt in zip(rows, rts):
        row["retention_time"] = float(rt)
    store = SpectrumStore(str(tmp_path_factory.mktemp("ivf_rt_spectra")))
    writer = store.writer(batch_size=37)
    writer.add_many(rows)
    writer.close()
    return store.dataset(2)


@pytest.mark.parametrize("rerank", ["exact", "off"])
def test_engine_rt_filter_matches_jax(rt_dataset, rerank):
    # The RT filter of the IVF lists runs on the device in float64: the
    # JAX package's labels and medoids, and the filter drops neighbours.
    kw = dict(rerank=rerank, n_probe=4, rt_tol=20.0)
    got = _generate(ann_engine, rt_dataset, **kw)
    want = _generate(jax_engine, rt_dataset, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    unfiltered = _generate(ann_engine, rt_dataset, **dict(kw, rt_tol=None))
    assert len(np.unique(got[0])) > len(np.unique(unfiltered[0]))
