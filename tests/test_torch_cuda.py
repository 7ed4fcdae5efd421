"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: every test skips where ``torch.cuda.is_available()`` is
false (a CUDA kernel has no CPU or interpret mode).  On a machine with an
NVIDIA Hopper GPU and nvcc::

    python -m pytest -m cuda tests/test_torch_cuda.py

The kernels and their plain versions add the selected weights in the same
order, so scores must agree to 1e-6 and match counts exactly; the engine
must give identical labels and medoids through the kernels on the GPU and
through the plain versions on the CPU.  Every matching kernel walks the
peak pairs within tolerance of a row sorted by m/z, so each is also held
against its plain version on peaks in no m/z order, on tie-heavy spectra
and at wide tolerances, where a column has many such pairs.  The vectorize
kernel (and its fused plain + spread call), the two medoid-score kernels
and the consensus kernel sum in their plain versions' order, so each
agrees with its plain version, on the card and on the CPU, bit for bit,
and so do two launches; the scan, the rerank and dbscan mode built on the
kernels agree with their CPU versions.
"""

import numpy as np
import pytest
import torch

from falcon_tpu_torch.cluster import ann_engine, engine
from falcon_tpu_torch.ops import consensus as cs
from falcon_tpu_torch.ops import exact_knn as ex
from falcon_tpu_torch.ops import groupby
from falcon_tpu_torch.ops import knn
from falcon_tpu_torch.ops import medoids as md
from falcon_tpu_torch.ops import rerank
from falcon_tpu_torch.ops import pairwise as pw
from falcon_tpu_torch.ops import vectorize as vz
from falcon_tpu_torch.preprocess import process_spectrum
from falcon_tpu_torch.simulate import make_clustered_spectra
from falcon_tpu_torch.store.store import SpectrumStore, padded_peaks
from torch_cases import (GROUPBY_CASES, consensus_peaks, consensus_skewed,
                         groupby_keys, medoid_hub_lists, medoid_lists,
                         permuted, tie_heavy, tiers_reached)

pytestmark = pytest.mark.cuda

TOL = 0.05
ATOL = 1e-6


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels run only on the card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def rows():
    spectra, _ = make_clustered_spectra(
        n_clusters=40, cluster_size=6, n_noise=200, seed=13, charges=(2,),
        precursor_mz_range=(600.0, 600.5),
    )
    out = [process_spectrum(s, 5, 250, 101.0, 1500.0, 1.5, 0.01, 50, None)
           for s in spectra]
    return sorted((r for r in out if r is not None),
                  key=lambda r: r["precursor_mz"])


def _padded(rows, device):
    offsets = np.zeros(len(rows) + 1, np.int64)
    offsets[1:] = np.cumsum([len(r["mz"]) for r in rows])
    mz, intensity, _ = padded_peaks(
        offsets, np.concatenate([r["mz"] for r in rows]),
        np.concatenate([r["intensity"] for r in rows]), 64)
    return (torch.from_numpy(mz).to(device),
            torch.from_numpy(intensity).to(device))


def _assert_same(got, want):
    assert float((got[0] - want[0]).abs().max()) <= ATOL
    assert (got[1] is None) == (want[1] is None)
    if got[1] is not None:
        assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("upper_only", [False, True])
@pytest.mark.parametrize("with_matches", [False, True])
@pytest.mark.parametrize("rounds", [1, 8])
def test_panel_kernel_matches_plain(cuda, rows, upper_only, with_matches,
                                    rounds):
    mz, intensity = _padded(rows, cuda)
    n = 333  # not a multiple of the kernel's 32-column blocks
    args = (mz[40:140], intensity[40:140], mz[:n], intensity[:n], 40, TOL,
            rounds, upper_only, with_matches)
    before = pw.panel_scores.launches
    got = pw.panel_scores(*args)
    torch.cuda.synchronize()
    assert pw.panel_scores.launches == before + 1
    _assert_same(got, pw.panel_scores_plain(*args))


@pytest.mark.parametrize("with_matches", [False, True])
def test_grouped_kernel_matches_plain(cuda, rows, with_matches):
    mz, intensity = _padded(rows, cuda)
    sizes = [0, 1, 2, 37, 1, 64, 129]  # empty and single-spectrum too
    starts = torch.tensor(np.concatenate([[0], np.cumsum(sizes)]),
                          device=cuda)
    n = int(starts[-1])
    args = (mz[:n], intensity[:n], starts, TOL, 8, with_matches)
    before = pw.batched_block_scores.launches
    got = pw.batched_block_scores(*args)
    torch.cuda.synchronize()
    assert pw.batched_block_scores.launches == before + 1
    _assert_same(got, pw.batched_block_scores_plain(*args))


def test_kernels_reject_unsupported_inputs(cuda, rows):
    mz, intensity = _padded(rows[:8], cuda)
    wide = torch.nn.functional.pad(mz, (0, 64), value=pw.PAD_MZ)
    wide_int = torch.nn.functional.pad(intensity, (0, 64))
    with pytest.raises(ValueError, match="64 peaks"):
        pw.panel_scores(wide, wide_int, wide, wide_int, 0, TOL)
    with pytest.raises(ValueError, match="tensors on"):
        pw.panel_scores(mz, intensity, mz.cpu(), intensity.cpu(), 0, TOL)
    # A contiguous pool one float off a 16-byte boundary: cp.async cannot
    # copy its rows.
    flat = torch.zeros(mz.numel() + 1, device=cuda)
    flat[1:] = mz.reshape(-1)
    ids = torch.zeros((8, 4), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        pw.pair_list_scores(mz, intensity, flat[1:].view(mz.shape),
                            intensity, ids, TOL, 4)


@pytest.mark.parametrize("min_matches", [0, 6])
def test_condensed_distances_gpu_equals_cpu(cuda, rows, min_matches):
    mz, intensity = (a.cpu().numpy() for a in _padded(rows, "cpu"))
    n = 300
    got = pw.condensed_distances(mz[:n], intensity[:n], TOL, min_matches,
                                 panel_rows=128, device=cuda)
    want = pw.condensed_distances(mz[:n], intensity[:n], TOL, min_matches,
                                  panel_rows=128, device="cpu")
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("panel_only", [False, True],
                         ids=["grouped", "panel"])
def test_engine_gpu_equals_cpu(cuda, rows, tmp_path, panel_only):
    store = SpectrumStore(str(tmp_path / "spectra"))
    writer = store.writer()
    writer.add_many(rows)
    writer.close()
    args = (store.dataset(2), "complete", 0.1, 0, 20.0, "ppm", None, TOL,
            2**15)
    labels, medoids = engine.generate_clusters(*args, device=cuda,
                                               panel_only=panel_only)
    ref_labels, ref_medoids = engine.generate_clusters(
        *args, device="cpu", panel_only=panel_only)
    np.testing.assert_array_equal(labels, ref_labels)
    np.testing.assert_array_equal(medoids, ref_medoids)


@pytest.mark.parametrize("pass_offset,window", [(0, 256), (128, 128),
                                                (0, 96)])
@pytest.mark.parametrize("with_matches", [False, True])
@pytest.mark.parametrize("rounds", [1, 4])
def test_banded_kernel_matches_plain(cuda, rows, pass_offset, window,
                                     with_matches, rounds):
    mz, intensity = _padded(rows, cuda)
    n_pool = mz.shape[0] // 128 * 128
    pool = mz[:n_pool].contiguous(), intensity[:n_pool].contiguous()
    max_start = (n_pool - pass_offset - window) // 128
    starts = torch.arange(70, device=cuda, dtype=torch.int32) % (
        max_start + 1)
    args = (mz[10:80], intensity[10:80], *pool, starts, pass_offset, window,
            TOL, rounds, with_matches)
    before = ex.banded_panel_scores.launches
    got = ex.banded_panel_scores(*args)
    torch.cuda.synchronize()
    assert ex.banded_panel_scores.launches == before + 1
    _assert_same(got, ex.banded_panel_scores_plain(*args))


@pytest.mark.parametrize("with_matches", [False, True])
def test_pair_list_kernel_matches_plain(cuda, rows, with_matches):
    mz, intensity = _padded(rows, cuda)
    gen = torch.Generator(device="cpu").manual_seed(0)
    ids = torch.randint(0, mz.shape[0], (50, 37), generator=gen)
    ids[torch.rand(ids.shape, generator=gen) < 0.3] = -1
    ids[7] = -1  # a row with no pairs at all
    args = (mz[:50], intensity[:50], mz, intensity, ids.to(cuda), TOL, 4,
            with_matches)
    before = pw.pair_list_scores.launches
    got = pw.pair_list_scores(*args)
    torch.cuda.synchronize()
    assert pw.pair_list_scores.launches == before + 1
    _assert_same(got, pw.pair_list_scores_plain(*args))


@pytest.mark.parametrize("min_matches", [0, 6])
def test_exact_banded_topk_gpu_equals_cpu(cuda, rows, min_matches):
    mz, intensity = _padded(rows, "cpu")
    n = len(rows)
    pad = 512 - n
    mz = torch.nn.functional.pad(mz, (0, 0, 0, pad), value=pw.PAD_MZ)
    intensity = torch.nn.functional.pad(intensity, (0, 0, 0, pad))
    pmz = np.asarray([r["precursor_mz"] for r in rows])
    rts = np.asarray([r["retention_time"] for r in rows])
    args = (pmz, 20.0, "ppm", 16, TOL, 4, rts, 600.0, min_matches)
    got = ex.exact_banded_topk(mz.to(cuda), intensity.to(cuda), *args,
                               block_rows=128, pass_width=128)
    want = ex.exact_banded_topk(mz, intensity, *args)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.parametrize("linkage", ["complete", "average"])
def test_ann_engine_gpu_equals_cpu(cuda, rows, tmp_path, monkeypatch,
                                   linkage):
    # Components over 4 spectra take the large routes: the pruned pair
    # lists (complete) and K1 (average).
    monkeypatch.setattr(ann_engine, "LINKAGE_GROUP_MAX", 4)
    store = SpectrumStore(str(tmp_path / "spectra"))
    writer = store.writer()
    writer.add_many(rows)
    writer.close()
    args = (store.dataset(2), 0.2, 2, 0, 20.0, "ppm", None, TOL, 2**15)
    before = (ex.banded_panel_scores.launches, pw.pair_list_scores.launches,
              pw.panel_scores.launches)
    labels, medoids = ann_engine.generate_clusters(
        *args, ann_index="exact", linkage=linkage, device=cuda)
    after = (ex.banded_panel_scores.launches, pw.pair_list_scores.launches,
             pw.panel_scores.launches)
    ref_labels, ref_medoids = ann_engine.generate_clusters(
        *args, ann_index="exact", linkage=linkage, device="cpu")
    np.testing.assert_array_equal(labels, ref_labels)
    np.testing.assert_array_equal(medoids, ref_medoids)
    assert after[0] > before[0]
    assert after[1 if linkage == "complete" else 2] > before[
        1 if linkage == "complete" else 2]


def _permuted(mz, intensity, seed):
    """``torch_cases.permuted`` of CUDA tensors, on their device."""
    return tuple(torch.from_numpy(a).to(mz.device) for a in permuted(
        mz.cpu().numpy(), intensity.cpu().numpy(), seed))


def _edge_walk(kernel, mz, intensity, tol, rounds):
    """(kernel, plain version) results of ``kernel`` on the first spectra
    of ``mz`` (a multiple of 128 rows), at a launch shape of its own."""
    n = mz.shape[0]
    dev = mz.device
    if kernel == "K1":
        args = (mz[3:100], intensity[3:100], mz, intensity, 3, tol, rounds)
        return pw.panel_scores(*args), pw.panel_scores_plain(*args)
    if kernel == "K2":
        starts = torch.arange(97, device=dev, dtype=torch.int32) % (
            n // 128)
        args = (mz[:97], intensity[:97], mz, intensity, starts, 0, 128, tol,
                rounds)
        return (ex.banded_panel_scores(*args),
                ex.banded_panel_scores_plain(*args))
    if kernel == "K4":
        # Empty, single and two-spectrum intervals, and rows of more than
        # 32 columns.
        sizes = [0, 1, 2, 37, 1, 64]
        sizes.append(n - sum(sizes))
        starts = torch.tensor(np.concatenate([[0], np.cumsum(sizes)]),
                              device=dev)
        args = (mz, intensity, starts, tol, rounds)
        return (pw.batched_block_scores(*args),
                pw.batched_block_scores_plain(*args))
    gen = torch.Generator(device="cpu").manual_seed(rounds)
    ids = torch.randint(0, n, (90, 70), generator=gen)
    ids[torch.rand(ids.shape, generator=gen) < 0.4] = -1
    ids[5] = -1  # a row with no pairs at all
    ids[6, 35:] = ids[6, :35]  # ids that repeat within a row
    args = (mz[:90], intensity[:90], mz, intensity, ids.to(dev), tol,
            rounds)
    return pw.pair_list_scores(*args), pw.pair_list_scores_plain(*args)


@pytest.mark.parametrize("rounds", [1, 8, 32])
@pytest.mark.parametrize("case", ["tie_heavy", "unsorted", "tol_0.5",
                                  "tol_2.0"])
@pytest.mark.parametrize("kernel", ["K1", "K2", "K4", "pair_lists"])
def test_edge_walking_kernels_match_plain(cuda, rows, kernel, case, rounds):
    if case == "tie_heavy":
        mz, intensity = (torch.from_numpy(a).to(cuda)
                          for a in tie_heavy(64, seed=rounds))
    else:
        mz, intensity = _padded(rows, cuda)
    if case == "unsorted":
        mz, intensity = _permuted(mz, intensity, seed=rounds)
    tol = float(case[4:]) if case.startswith("tol_") else TOL
    n = mz.shape[0] // 128 * 128
    got, want = _edge_walk(kernel, mz[:n].contiguous(),
                           intensity[:n].contiguous(), tol, rounds)
    torch.cuda.synchronize()
    _assert_same(got, want)


@pytest.mark.parametrize("kernel", ["K1", "K2", "K4", "pair_lists"])
def test_edge_walking_kernels_ignore_peak_order(cuda, rows, kernel):
    # The same spectra with their peaks in another order: the same
    # matching, its weights summed over the columns in another order.
    mz, intensity = _padded(rows, cuda)
    pmz, pint = _permuted(mz, intensity, seed=5)
    n = mz.shape[0] // 128 * 128
    out = [_edge_walk(kernel, m[:n].contiguous(), x[:n].contiguous(), TOL,
                      8)[0] for m, x in ((mz, intensity), (pmz, pint))]
    torch.cuda.synchronize()
    _assert_same(out[1], out[0])


def _hasher_args(mz, intensity, low_dim=400):
    hasher = vz.SpectrumHasher(101.0, 1500.0, TOL, low_dim, 3)
    return (mz, intensity, hasher._mapping(mz.device), hasher.min_bound,
            hasher.bin_size, hasher.n_bins, hasher.dim_padded)


@pytest.mark.parametrize("norm", [False, True])
@pytest.mark.parametrize("spread", [False, True])
@pytest.mark.parametrize("case", ["sorted", "permuted_out_of_range",
                                  "low_dim_1600"])
def test_vectorize_kernel_bit_identical_to_plain(cuda, rows, spread, norm,
                                                 case):
    mz, intensity = _padded(rows, cuda)
    low_dim = 1600 if case == "low_dim_1600" else 400
    if case == "permuted_out_of_range":
        mz, intensity = _permuted(mz, intensity, seed=7)
        # Real peaks below and above the binning range: no bin.
        mz[:, :2] = torch.tensor([50.0, 2500.0], device=cuda)
        intensity[:, :2] = 0.5
    args = _hasher_args(mz, intensity, low_dim) + (norm, spread)
    before = vz.vectorize.launches
    got = vz.vectorize(*args)
    again = vz.vectorize(*args)
    torch.cuda.synchronize()
    assert vz.vectorize.launches == before + 2
    assert got.shape == (mz.shape[0], args[6])
    assert (got[:, low_dim:] == 0).all()
    assert torch.equal(got, again)
    assert torch.equal(got, vz.vectorize_plain(*args))
    cpu_args = tuple(a.cpu() if torch.is_tensor(a) else a for a in args)
    assert torch.equal(got.cpu(), vz.vectorize_plain(*cpu_args))


def test_vectorize_rejects_unsupported_inputs(cuda, rows):
    mz, intensity = _padded(rows[:8], cuda)
    args = _hasher_args(mz, intensity)
    with pytest.raises(TypeError, match="float32"):
        vz.vectorize(mz.double(), intensity.double(), *args[2:])
    with pytest.raises(ValueError, match="mapping"):
        vz.vectorize(mz, intensity, args[2].cpu(), *args[3:])
    wide = torch.nn.functional.pad(mz, (0, 64), value=pw.PAD_MZ)
    wide_int = torch.nn.functional.pad(intensity, (0, 64))
    with pytest.raises(ValueError, match="64 peaks"):
        vz.vectorize(wide, wide_int, *args[2:])


def _spectra_block(rows, device):
    """(peaks padded to 512 rows, precursor m/z, RTs) of ``rows``."""
    mz, intensity = _padded(rows, "cpu")
    pad = 512 - len(rows)
    mz = torch.nn.functional.pad(mz, (0, 0, 0, pad), value=pw.PAD_MZ)
    intensity = torch.nn.functional.pad(intensity, (0, 0, 0, pad))
    return (mz.to(device), intensity.to(device),
            np.asarray([r["precursor_mz"] for r in rows]),
            np.asarray([r["retention_time"] for r in rows]))


def test_knn_banded_gpu_equals_cpu(cuda, rows):
    mz, intensity, pmz, rts = _spectra_block(rows, cuda)
    plain = vz.vectorize(*_hasher_args(mz, intensity), False, False)
    spread = vz.vectorize(*_hasher_args(mz, intensity), False, True)
    kw = dict(rts=rts, rt_tol=900.0, scan_bf16=True, block_rows=128)
    got = knn.knn_banded(plain, pmz, 20.0, "ppm", 64, q_vectors=spread,
                         **kw)
    want = knn.knn_banded(plain.cpu(), pmz, 20.0, "ppm", 64,
                          q_vectors=spread.cpu(), **kw)
    scores, ids = (t.cpu().numpy() for t in got)
    assert float(np.abs(scores - want[0].numpy()).max()) <= ATOL
    gap = np.full(scores.shape, np.inf)
    step = np.abs(np.diff(scores, axis=1))
    gap[:, 1:] = np.minimum(gap[:, 1:], step)
    gap[:, :-1] = np.minimum(gap[:, :-1], step)
    distinct = gap > ATOL
    np.testing.assert_array_equal(ids[distinct], want[1].numpy()[distinct])
    assert (ids >= 0).sum() == (want[1] >= 0).sum() > len(rows)


def test_rerank_exact_gpu_equals_plain(cuda, rows):
    mz, intensity, pmz, _ = _spectra_block(rows, cuda)
    gen = torch.Generator(device="cpu").manual_seed(1)
    n = len(rows)
    ids = (torch.arange(n)[:, None]
           + torch.randint(-30, 31, (n, 45), generator=gen))
    ids[(ids < 0) | (ids >= n) | (torch.rand(ids.shape, generator=gen)
                                   < 0.3)] = -1
    neigh = torch.full((512, 45), -1, dtype=torch.int64)
    neigh[:n] = ids
    before = pw.pair_list_scores.launches
    got = rerank.rerank_exact(mz, intensity, neigh.to(cuda), TOL, 16)
    torch.cuda.synchronize()
    assert pw.pair_list_scores.launches == before + 1
    plain = rerank.rerank_scan_body(mz, intensity, mz, intensity,
                                    neigh.to(cuda), TOL, 16)
    cpu = rerank.rerank_exact(mz.cpu(), intensity.cpu(), neigh, TOL, 16)
    for a, b, c in zip(got, plain, cpu):
        assert torch.equal(a, b) and torch.equal(a.cpu(), c)


def test_default_ann_engine_gpu_equals_cpu(cuda, rows, tmp_path):
    store = SpectrumStore(str(tmp_path / "spectra"))
    writer = store.writer()
    writer.add_many(rows)
    writer.close()
    args = (store.dataset(2), 0.2, 2, 0, 20.0, "ppm", None, TOL, 2**15)
    before = (vz.vectorize_pair.launches, pw.pair_list_scores.launches)
    labels, medoids = ann_engine.generate_clusters(*args, device=cuda)
    assert vz.vectorize_pair.launches == before[0] + 1
    assert pw.pair_list_scores.launches > before[1]
    ref_labels, ref_medoids = ann_engine.generate_clusters(*args,
                                                           device="cpu")
    np.testing.assert_array_equal(labels, ref_labels)
    np.testing.assert_array_equal(medoids, ref_medoids)


@pytest.mark.parametrize("case", ["sorted", "permuted_out_of_range"])
def test_vectorize_pair_bit_identical_to_plain(cuda, rows, case):
    mz, intensity = _padded(rows, cuda)
    if case == "permuted_out_of_range":
        mz, intensity = _permuted(mz, intensity, seed=9)
        mz[:, :2] = torch.tensor([50.0, 2500.0], device=cuda)
        intensity[:, :2] = 0.5
    # Padded rows (zero intensity) are written without the hit machinery.
    mz = torch.nn.functional.pad(mz, (0, 0, 0, 40), value=pw.PAD_MZ)
    intensity = torch.nn.functional.pad(intensity, (0, 0, 0, 40))
    args = _hasher_args(mz, intensity)
    before = vz.vectorize_pair.launches
    got = vz.vectorize_pair(*args)
    again = vz.vectorize_pair(*args)
    torch.cuda.synchronize()
    assert vz.vectorize_pair.launches == before + 2
    want = vz.vectorize_pair_plain(*args)
    for g, a, w, single in zip(got, again, want, (
            vz.vectorize(*args, False, False),
            vz.vectorize(*args, False, True))):
        assert torch.equal(g, a) and torch.equal(g, w)
        assert torch.equal(g, single)
        assert (g[-40:] == 0).all()


def _medoid_lists(n, n_pad, k, seed, device):
    """Sparse lists with mutual and one-way edges, -1 slots, a spill
    segment and duplicate rows (``tests/test_torch_dbscan.py``'s)."""
    sims, neigh, seg, n_seg = medoid_lists(n, n_pad, k, seed)
    seg_pad = np.full(n_pad, n_seg - 1, np.int32)
    seg_pad[:n] = seg
    return (torch.from_numpy(sims).to(device),
            torch.from_numpy(neigh).to(device),
            torch.from_numpy(seg_pad).to(device), n_seg - 1)


@pytest.mark.parametrize("n,n_pad,k", [(300, 512, 16), (300, 512, 48),
                                       (1500, 2048, 64), (700, 1024, 37)])
def test_sparse_medoid_kernel_bit_identical_to_plain(cuda, n, n_pad, k):
    args = _medoid_lists(n, n_pad, k, n + k, cuda)
    before = md.sparse_medoid_scores.launches
    got = md.sparse_medoid_scores(*args)
    again = md.sparse_medoid_scores(*args)
    torch.cuda.synchronize()
    assert md.sparse_medoid_scores.launches == before + 2
    assert torch.equal(got, again)
    assert torch.equal(got, md.sparse_medoid_scores_plain(*args))
    cpu = tuple(a.cpu() if torch.is_tensor(a) else a for a in args)
    assert torch.equal(got.cpu(), md.sparse_medoid_scores_plain(*cpu))


@pytest.mark.parametrize("dim", [512, 1664])
def test_hashed_medoid_kernel_bit_identical_to_plain(cuda, rows, dim):
    mz, intensity = _padded(rows, cuda)
    hasher = vz.SpectrumHasher(101.0, 1500.0, TOL, dim - 64 if dim > 512
                               else 400, 3)
    unit = vz.normalize_rows(hasher.vectorize(mz, intensity, norm=False))
    unit = torch.cat([unit, unit[:20]])  # duplicate rows
    rng = np.random.default_rng(dim)
    seg = rng.integers(0, 40, unit.shape[0]).astype(np.int32)  # 40: spill
    seg[-20:] = seg[:20]
    seg = torch.from_numpy(seg).to(cuda)
    before = md.hashed_medoid_scores.launches
    got = md.hashed_medoid_scores(unit, seg, 40)
    again = md.hashed_medoid_scores(unit, seg, 40)
    torch.cuda.synchronize()
    assert md.hashed_medoid_scores.launches == before + 2
    assert torch.equal(got, again)
    assert torch.equal(got, md.hashed_medoid_scores_plain(unit, seg, 40))
    assert torch.equal(got.cpu(), md.hashed_medoid_scores_plain(
        unit.cpu(), seg.cpu(), 40))
    assert torch.equal(got[-20:], got[:20])


@pytest.mark.parametrize("n", [1, 37, 20000])
def test_consensus_kernel_bit_identical_to_plain(cuda, n):
    arrays = tuple(torch.from_numpy(a).to(cuda)
                   for a in consensus_peaks(n, seed=n))
    before = cs.aggregate.launches
    got = cs.aggregate(*arrays)
    again = cs.aggregate(*arrays)
    torch.cuda.synchronize()
    assert cs.aggregate.launches == before + 2
    want = cs.aggregate_plain(*arrays)
    cpu = cs.aggregate_plain(*(a.cpu() for a in arrays))
    for g, a, w, c in zip(got, again, want, cpu):
        assert torch.equal(g, a) and torch.equal(g, w)
        assert torch.equal(g.cpu(), c)


@pytest.mark.parametrize("case", sorted(GROUPBY_CASES))
def test_groupby_kernels_equal_stable_sort(cuda, case):
    key, n_groups, shift = groupby_keys(case, seed=3)
    want = groupby.group_by_plain(torch.from_numpy(key), n_groups, shift)
    assert tiers_reached(np.diff(want[0].numpy()), groupby.WARP_CAP) == \
        GROUPBY_CASES[case][1]
    before = groupby.group_by.launches
    got = groupby.group_by(torch.from_numpy(key).to(cuda), n_groups, shift)
    again = groupby.group_by(torch.from_numpy(key).to(cuda), n_groups, shift)
    torch.cuda.synchronize()
    assert groupby.group_by.launches == before + 2
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a) and torch.equal(g.cpu(), w)


@pytest.mark.parametrize("k", [16, 24])
def test_sparse_medoid_kernel_hub_bit_identical_to_plain(cuda, k):
    # In-degrees of 1,281 (a block's sort), 80 (a warp's) and a few.
    sims, neigh, seg, n_seg = medoid_hub_lists(1500, 2048, k, seed=k)
    seg_pad = np.full(2048, n_seg - 1, np.int32)
    seg_pad[:1500] = seg
    args = (torch.from_numpy(sims).to(cuda), torch.from_numpy(neigh).to(cuda),
            torch.from_numpy(seg_pad).to(cuda), n_seg - 1)
    assert tiers_reached(np.bincount(neigh[neigh >= 0]),
                         groupby.WARP_CAP) == (True, True, True)
    got = md.sparse_medoid_scores(*args)
    again = md.sparse_medoid_scores(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got, md.sparse_medoid_scores_plain(*args))
    cpu = tuple(a.cpu() if torch.is_tensor(a) else a for a in args)
    assert torch.equal(got.cpu(), md.sparse_medoid_scores_plain(*cpu))


@pytest.mark.parametrize("with_max_key", [False, True])
@pytest.mark.parametrize("n,case", [(4096, "hot_key"), (200, "one_bucket"),
                                    (5000, "one_bucket")])
def test_consensus_kernel_skewed_bit_identical_to_plain(cuda, n, case,
                                                        with_max_key):
    arrays = consensus_skewed(n, n, case)
    max_key = int(arrays[0].max()) + 1
    shift, n_buckets = cs.bucket_shift(max_key, n)
    sizes = np.bincount(arrays[0] >> shift, minlength=n_buckets)
    assert {"hot_key": (True, True, True), "one_bucket": (
        False, n <= cs.WARP_CAP, n > cs.WARP_CAP)}[case] == tiers_reached(
            sizes, cs.WARP_CAP)
    arrays = tuple(torch.from_numpy(a).to(cuda) for a in arrays)
    kw = dict(max_key=max_key) if with_max_key else {}
    got = cs.aggregate(*arrays, **kw)
    again = cs.aggregate(*arrays, **kw)
    torch.cuda.synchronize()
    want = cs.aggregate_plain(*arrays)
    cpu = cs.aggregate_plain(*(a.cpu() for a in arrays))
    for g, a, w, c in zip(got, again, want, cpu):
        assert torch.equal(g, a) and torch.equal(g, w)
        assert torch.equal(g.cpu(), c)


@pytest.mark.parametrize("case", ["auto", "exact", "rerank_off",
                                  "rerank_off_linkage"])
def test_dbscan_engine_gpu_equals_cpu(cuda, rows, tmp_path, case):
    store = SpectrumStore(str(tmp_path / "spectra"))
    writer = store.writer()
    writer.add_many(rows)
    writer.close()
    kw = dict(cluster_method="dbscan")
    if case == "exact":
        kw.update(ann_index="exact", min_samples=3)
    elif case.startswith("rerank_off"):
        kw.update(rerank="off")
    if case == "rerank_off_linkage":
        kw.update(cluster_method="linkage")
    args = (store.dataset(2), 0.2, kw.pop("min_samples", 2), 0, 20.0, "ppm",
            None, TOL, 2**15)
    counts = (md.sparse_medoid_scores, md.hashed_medoid_scores)
    before = [c.launches for c in counts]
    labels, medoids = ann_engine.generate_clusters(*args, device=cuda, **kw)
    launched = [c.launches - b for c, b in zip(counts, before)]
    ref_labels, ref_medoids = ann_engine.generate_clusters(*args,
                                                           device="cpu", **kw)
    np.testing.assert_array_equal(labels, ref_labels)
    np.testing.assert_array_equal(medoids, ref_medoids)
    assert launched == {"auto": [1, 0], "exact": [1, 0],
                        "rerank_off": [0, 1],
                        "rerank_off_linkage": [0, 0]}[case]


def test_consensus_spectra_gpu_equals_cpu(cuda, rows):
    offsets = np.concatenate([[0], np.cumsum([len(r["mz"]) for r in rows])])
    mz = np.concatenate([r["mz"] for r in rows])
    intensity = np.concatenate([r["intensity"] for r in rows])
    labels = np.arange(len(rows)) // 4
    args = (offsets, mz, intensity, labels, TOL, 101.0)
    got = cs.consensus_spectra(*args, device=cuda)
    want = cs.consensus_spectra(*args, device="cpu")
    assert sorted(got) == sorted(want)
    for label in want:
        for g, w in zip(got[label], want[label]):
            np.testing.assert_array_equal(g, w)
