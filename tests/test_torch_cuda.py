"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: every test skips where ``torch.cuda.is_available()`` is
false (a CUDA kernel has no CPU or interpret mode).  On a machine with an
NVIDIA Hopper GPU and nvcc::

    python -m pytest -m cuda tests/test_torch_cuda.py

The kernels and their plain versions add the selected weights in the same
order (XLA's CPU order, ``ops/matching.py``), so scores must agree bit for
bit, with match counts and with a second launch of the kernel; the engine
must give identical labels and medoids through the kernels on the GPU and
through the plain versions on the CPU.  Every matching kernel walks the
peak pairs within tolerance of a row sorted by m/z, so each is also held
against its plain version on peaks in no m/z order, on tie-heavy spectra
and at wide tolerances, where a column has many such pairs.  The vectorize
kernel (and its fused plain + spread call), the two medoid-score kernels
and the consensus kernel sum in their plain versions' order, so each
agrees with its plain version, on the card and on the CPU, bit for bit,
and so do two launches; the scan, the rerank and dbscan mode built on the
kernels agree with their CPU versions.  The IVF probe scan's chunk step
(IVF.1: mask, dots and stable top k) and the k-means update (IVF.2) agree
with their plain versions bit for bit, on the card and on the CPU, the
step at 20 ppm, 0.05 Da and an infinite tolerance, at k = 1, 256 and every
pair, on a block with exact copies (score ties) and on rows longer than
one sort run, the update on the bench block's and the largest block's
training shapes and on one list of 20,000 rows, and the ann engine's
``--ann_index ivf`` gives the CPU's labels and medoids, with no list of
the index copied to the host between its search and its rerank.  On
``[cuda:0] x 4`` (``FALCON_TPU_TORCH_VIRTUAL_DEVICES``) the sharded ann
chain gives one device's labels and the CPU's sharded labels and medoids,
through the vectorize, pair-list and B.2 kernels; blocks two deep give the
serial loop's; a pair-list launch from a worker thread on its own stream
equals the main thread's; the halo-pool rerank and B.2's sums and dots
alone equal their plain versions bit for bit.  The rest of ``--devices
N`` on ``[cuda:0] x 4``: K1 on each shard's condensed slice equals its
plain version and the one-device distances, and the exact backend one
device's labels; the exact index's pair lists on windowed halo pools equal
their plain version and the CPU's, and its labels one device's; IVF.1 with
the probes outside a ring step's block masked equals its plain version,
the ring on the kernel equals the ring on plain versions (and one device's
scores), and the IVF engine's sharded labels equal the CPU's.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from falcon_tpu_torch.cluster import ann_engine, engine
from falcon_tpu_torch.device import VIRTUAL_DEVICES_ENV, worker_stream
from falcon_tpu_torch.ops import consensus as cs
from falcon_tpu_torch.ops import exact_knn as ex
from falcon_tpu_torch.ops import groupby
from falcon_tpu_torch.ops import knn
from falcon_tpu_torch.ops import medoids as md
from falcon_tpu_torch.ops import rerank
from falcon_tpu_torch.ops import pairwise as pw
from falcon_tpu_torch.ops import vectorize as vz
from falcon_tpu_torch.parallel import mesh, sharded_pipeline
from falcon_tpu_torch.preprocess import process_spectrum
from falcon_tpu_torch.simulate import make_clustered_spectra
from falcon_tpu_torch.store.store import SpectrumStore, padded_peaks
from falcon_tpu_torch.utils.profiling import profiler
from torch_cases import (GROUPBY_CASES, consensus_peaks, consensus_skewed,
                         groupby_keys, medoid_hub_lists, medoid_lists,
                         permuted, tie_heavy, tiers_reached)

pytestmark = pytest.mark.cuda

TOL = 0.05
# Where two computations add in different orders: permuted peaks (the
# blocks of the selection hold other entries) and the scan's vectors.
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


def _assert_same(got, want, again=None, atol=0.0):
    """Scores (bit for bit unless ``atol``) and match counts, and the same
    bits from a second launch."""
    if atol:
        assert float((got[0] - want[0]).abs().max()) <= atol
    else:
        assert torch.equal(got[0], want[0])
    assert (got[1] is None) == (want[1] is None)
    if got[1] is not None:
        assert torch.equal(got[1], want[1])
    if again is not None:
        assert torch.equal(again[0], got[0])
        assert got[1] is None or torch.equal(again[1], got[1])


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
    got, again = pw.panel_scores(*args), pw.panel_scores(*args)
    torch.cuda.synchronize()
    assert pw.panel_scores.launches == before + 2
    _assert_same(got, pw.panel_scores_plain(*args), again)


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
    again = pw.batched_block_scores(*args)
    torch.cuda.synchronize()
    assert pw.batched_block_scores.launches == before + 2
    _assert_same(got, pw.batched_block_scores_plain(*args), again)


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
    np.testing.assert_array_equal(got, want)


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
    again = ex.banded_panel_scores(*args)
    torch.cuda.synchronize()
    assert ex.banded_panel_scores.launches == before + 2
    _assert_same(got, ex.banded_panel_scores_plain(*args), again)


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
    got, again = pw.pair_list_scores(*args), pw.pair_list_scores(*args)
    torch.cuda.synchronize()
    assert pw.pair_list_scores.launches == before + 2
    _assert_same(got, pw.pair_list_scores_plain(*args), again)


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
    # matching, its weights summed in another order (the blocks of the
    # selection hold other entries).
    mz, intensity = _padded(rows, cuda)
    pmz, pint = _permuted(mz, intensity, seed=5)
    n = mz.shape[0] // 128 * 128
    out = [_edge_walk(kernel, m[:n].contiguous(), x[:n].contiguous(), TOL,
                      8)[0] for m, x in ((mz, intensity), (pmz, pint))]
    torch.cuda.synchronize()
    _assert_same(out[1], out[0], atol=ATOL)


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


def _hashed_inputs(rows, device, dim, big):
    """Unit vectors of the rows at ``dim`` with 20 duplicate rows, and 40
    clusters (40: the spill segment); ``big``: the vectors repeated to
    3,400 rows, the first 3,000 of them one cluster (and the last 20,
    their duplicates)."""
    mz, intensity = _padded(rows, device)
    hasher = vz.SpectrumHasher(101.0, 1500.0, TOL, dim - 64 if dim > 512
                               else 400, 3)
    unit = vz.normalize_rows(hasher.vectorize(mz, intensity, norm=False))
    if big:
        unit = unit.repeat(-(-3400 // unit.shape[0]), 1)[:3380]
    unit = torch.cat([unit, unit[:20]])  # duplicate rows
    rng = np.random.default_rng(dim)
    seg = rng.integers(0, 40, unit.shape[0]).astype(np.int32)  # 40: spill
    if big:
        seg[:3000] = 0
    seg[-20:] = seg[:20]
    return unit, torch.from_numpy(seg).to(device)


@pytest.mark.parametrize("dim,big", [
    pytest.param(512, False, id="512"), pytest.param(1664, False, id="1664"),
    pytest.param(512, True, id="512-cluster3000"),
    pytest.param(1664, True, id="1664-cluster3000")])
def test_hashed_medoid_kernel_bit_identical_to_plain(cuda, rows, dim, big):
    unit, seg = _hashed_inputs(rows, cuda, dim, big)
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
    # The group-by's order: each cluster's rows ascending, noise dropped.
    with torch.cuda.device(cuda):
        off, items = md._cluster_rows(seg, 40, md._stream(cuda))
    want_rows, want_off = md._segments(seg, 40)
    assert torch.equal(off.long(), want_off.long())
    assert torch.equal(items[:int(off[-1])].long(),
                       want_rows[:int(want_off[-1])].long())


def test_hashed_medoid_kernel_runs_no_sort(cuda, rows):
    # One call's torch.profiler trace: the group-by, the sums and the dots,
    # and no sort or search kernel.
    from torch.profiler import ProfilerActivity, profile

    unit, seg = _hashed_inputs(rows, cuda, 512, True)
    md.hashed_medoid_scores(unit, seg, 40)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        md.hashed_medoid_scores(unit, seg, 40)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if getattr(e, "device_time_total",
                        getattr(e, "cuda_time_total", 0.0)) > 0]
    assert any("hashed_medoid_sums" in k for k in names), names
    assert any("hashed_medoid_dot" in k for k in names), names
    assert any("groupby_order" in k for k in names), names
    assert not [k for k in names
                if "sort" in k.lower() or "search" in k.lower()], names


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


@pytest.fixture(scope="module")
def ivf_block():
    """A 4,096-spectrum block of one charge sorted by precursor m/z: its
    peaks and precursor m/z (on the host)."""
    spectra, _ = make_clustered_spectra(
        n_clusters=300, cluster_size=8, n_noise=1800, seed=17, charges=(2,),
        precursor_mz_range=(500.0, 520.0))
    out = [process_spectrum(s, 5, 250, 101.0, 1500.0, 1.5, 0.01, 50, None)
           for s in spectra]
    rows = sorted((r for r in out if r is not None),
                  key=lambda r: r["precursor_mz"])[:4096]
    return rows, np.asarray([r["precursor_mz"] for r in rows])


def _ivf_index(cuda, ivf_block, precise):
    from falcon_tpu_torch.ops import ivf

    rows, pmz = ivf_block
    mz, intensity = _padded(rows, cuda)
    plain, spread = vz.SpectrumHasher(101.0, 1500.0, TOL).vectorize_pair(
        mz, intensity)
    if precise:
        return ivf.IVFIndex(vz.normalize_rows(plain), pmz, precise=True,
                            coarse_vectors=vz.normalize_rows(spread)), pmz
    return ivf.IVFIndex(plain, pmz, coarse_vectors=vz.normalize_rows(spread),
                        rank_vectors=spread), pmz


@pytest.fixture(scope="module")
def ivf_block_copies(ivf_block):
    """``ivf_block`` with exact copies: 3,072 of its spectra and 1,024
    copies of some of them, sorted by precursor m/z (copies score ties)."""
    rows, _ = ivf_block
    picks = np.random.default_rng(23).choice(3072, 1024, replace=False)
    out = sorted(rows[:3072] + [dict(rows[i]) for i in picks],
                 key=lambda r: r["precursor_mz"])
    return out, np.asarray([r["precursor_mz"] for r in out])


def _probe_layout(index, dev, n_probe):
    q3d = index._corpus3d if index._query3d is None else index._query3d
    # The hashed vectors are non-negative, so no in-band score reaches NEG.
    assert (q3d >= 0).all() and (index._corpus3d >= 0).all()
    return (q3d, index._mz3d, index._row3d, index._corpus3d, index._mz3d,
            index._row3d, torch.from_numpy(index._probe_ids(n_probe)).to(dev))


def _check_probe_topk(dev, index, n_probe, tol, da, k, chunk, lists=None):
    from falcon_tpu_torch.ops import ivf

    layout = _probe_layout(index, dev, n_probe)
    before = ivf.probe_topk.launches
    starts = range(0, index.n_lists, chunk) if lists is None else lists
    ties = 0
    for c0 in starts:
        args = layout + (tol, da, k, c0, chunk)
        got, again = ivf.probe_topk(*args), ivf.probe_topk(*args)
        want = ivf.probe_topk_plain(*args)
        for g, a, w in zip(got, again, want):
            assert torch.equal(g, w) and torch.equal(g, a)
        if c0 == 0:
            cpu = ivf.probe_topk_plain(*(
                a.cpu() if isinstance(a, torch.Tensor) else a for a in args))
            assert all(torch.equal(g.cpu(), c) for g, c in zip(got, cpu))
        s = got[0].view(-1, k)
        ties += int(((s[:, 1:] == s[:, :-1]) & (s[:, 1:] > knn.NEG)).sum())
    assert ivf.probe_topk.launches == before + 2 * len(starts)
    return ties


@pytest.mark.parametrize("k", ["1", "256", "all"])
@pytest.mark.parametrize("precise,tol,da", [
    (False, 20.0, False), (False, np.inf, True), (True, 0.05, True),
    (True, np.inf, False)], ids=["bf16_20ppm", "bf16_inf", "f32_0.05Da",
                                 "f32_inf"])
@pytest.mark.parametrize("block", ["distinct", "copies"])
def test_ivf_probe_topk_bit_identical_to_plain(cuda, ivf_block,
                                               ivf_block_copies, block,
                                               precise, tol, da, k):
    # IVF.1's chunk step: each row's stable top k of its probe pairs, with
    # their slots, bit for bit the plain version's (the stable sort of
    # the whole score buffer), its own second launch's and the CPU's; rows
    # of up to 512 in-band pairs take a warp, longer ones (every pair at
    # tol = inf) the block, with a radix select where k is smaller.
    index, _ = _ivf_index(cuda, ivf_block if block == "distinct"
                          else ivf_block_copies, precise)
    n_probe, lb = 8, index._lb
    k = {"1": 1, "256": 256, "all": n_probe * lb}[k]
    ties = _check_probe_topk(cuda, index, n_probe, tol, da, k,
                             min(8, index.n_lists))
    if block == "copies" and k > 1:
        assert ties > 0


@pytest.mark.parametrize("tol,da", [(20.0, False), (0.05, True)])
def test_ivf_probe_topk_queries_in_no_mz_order(cuda, ivf_block_copies, tol,
                                               da):
    # External queries fill a list's slots in the caller's order, not by
    # m/z: the mask's skip of query tiles must hold for any order.
    from falcon_tpu_torch.ops import ivf

    index, _ = _ivf_index(cuda, ivf_block_copies, False)
    layout = _probe_layout(index, cuda, 8)
    perm = torch.from_numpy(np.random.default_rng(5).permutation(
        index._lb)).to(cuda)
    queries = tuple(a[:, perm].contiguous() for a in layout[:3])
    for c0 in range(0, index.n_lists, 16):
        args = queries + layout[3:] + (tol, da, 64, c0, 16)
        got, again = ivf.probe_topk(*args), ivf.probe_topk(*args)
        want = ivf.probe_topk_plain(*args)
        for g, a, w in zip(got, again, want):
            assert torch.equal(g, w) and torch.equal(g, a)
    assert (got[1] >= 0).any()


@pytest.mark.parametrize("k", [5000, "all"])
def test_ivf_probe_topk_rows_longer_than_a_run(cuda, ivf_block_copies, k):
    # Every list probed at tol = inf: rows of ~8,000 pairs, more than one
    # sort run (4,096 keys) of the block, with and without the select.
    index, _ = _ivf_index(cuda, ivf_block_copies, True)
    n_probe = index.n_lists
    k = n_probe * index._lb if k == "all" else k
    _check_probe_topk(cuda, index, n_probe, np.inf, True, k, 2,
                      lists=[0, index.n_lists - 2])


@pytest.mark.parametrize("shape", ["64_lists", "64_lists_skew",
                                   "1024_lists_131072_rows", "hot_list"])
def test_ivf_kmeans_update_bit_identical_to_plain(cuda, ivf_block, shape):
    from falcon_tpu_torch.ops import ivf

    rows, _ = ivf_block
    mz, intensity = _padded(rows, cuda)
    vecs = vz.normalize_rows(vz.SpectrumHasher(101.0, 1500.0, TOL).vectorize(
        mz, intensity, norm=False, spread=True))
    n_lists = 1024 if shape == "1024_lists_131072_rows" else 64
    if shape in ("1024_lists_131072_rows", "hot_list"):
        # The largest block's training sample (131,072 rows), or the bench
        # block's (32,768), from the corpus's rows over and over.
        n = 131072 if shape == "1024_lists_131072_rows" else 32768
        vecs = vecs[torch.arange(n, device=cuda) % vecs.shape[0]]
    rng = np.random.default_rng(3)
    assign = rng.integers(0, n_lists, vecs.shape[0]).astype(np.int32)
    assign[assign == 7] = 8  # an empty list keeps its centroid
    if shape == "64_lists_skew":
        assign[:3000] = 0  # a list of over 3,000 rows
    if shape == "hot_list":
        assign[rng.choice(len(assign), 20000, replace=False)] = 1
    assign = torch.from_numpy(assign).to(cuda)
    centroids = vecs[torch.arange(n_lists, device=cuda) * 61
                     % vecs.shape[0]]
    before = ivf.kmeans_update.launches
    got = ivf.kmeans_update(vecs, assign, centroids)
    again = ivf.kmeans_update(vecs, assign, centroids)
    assert ivf.kmeans_update.launches == before + 2
    want = ivf.kmeans_update_plain(vecs, assign, centroids)
    assert torch.equal(got, want) and torch.equal(got, again)
    assert torch.equal(got.cpu(), ivf.kmeans_update_plain(
        vecs.cpu(), assign.cpu(), centroids.cpu()))
    assert torch.equal(got[7], centroids[7])


@pytest.mark.parametrize("case", ["linkage", "dbscan", "rerank_off_dbscan",
                                  "pruned"])
def test_ivf_engine_gpu_equals_cpu(cuda, rows, tmp_path, case,
                                   monkeypatch):
    from falcon_tpu_torch.ops import ivf

    store = SpectrumStore(str(tmp_path / "spectra"))
    writer = store.writer()
    writer.add_many(rows)
    writer.close()
    kw = dict(ann_index="ivf")
    if case != "linkage":
        kw.update(cluster_method="dbscan")
    if case == "rerank_off_dbscan":
        kw.update(rerank="off")
    if case == "pruned":
        kw.update(n_probe=4)
    args = (store.dataset(2), 0.2, 2, 0, 20.0, "ppm", None, TOL, 2**15)
    # From the search to the rerank (or the return), nothing of the IVF
    # index is copied to the host: no tensor, list or scalar read.
    copies, window = [], []

    def to_cpu(a, k):
        return any(str(x).startswith("cpu") for x in a + tuple(k.values()))

    def from_cuda(a, k):
        return any(isinstance(x, torch.Tensor) and x.is_cuda
                   for x in a + tuple(k.values()))

    def watch(name, to_host):
        original = getattr(torch.Tensor, name)

        def watched(self, *a, **k):
            if window and to_host(self, a, k):
                copies.append((name, tuple(self.shape)))
            return original(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, watched)

    for name in ("cpu", "numpy", "tolist", "item", "__array__", "__bool__",
                 "__int__", "__float__", "__index__"):
        watch(name, lambda self, a, k: self.is_cuda)
    watch("to", lambda self, a, k: self.is_cuda and to_cpu(a, k))
    watch("copy_", lambda self, a, k: not self.is_cuda and from_cuda(a, k))
    search, lists, rerank_exact = (ivf.IVFIndex.self_search,
                                   ann_engine._ivf_lists,
                                   ann_engine.rerank_exact)

    def opened(*a, **k):
        window.append(True)
        return search(*a, **k)

    def closed_at_return(*a, **k):
        try:
            return lists(*a, **k)
        finally:
            window.clear()

    def closed_at_rerank(*a, **k):
        window.clear()
        return rerank_exact(*a, **k)

    monkeypatch.setattr(ivf.IVFIndex, "self_search", opened)
    monkeypatch.setattr(ann_engine, "_ivf_lists", closed_at_return)
    monkeypatch.setattr(ann_engine, "rerank_exact", closed_at_rerank)
    before = (ivf.probe_topk.launches, ivf.kmeans_update.launches)
    labels, medoids = ann_engine.generate_clusters(*args, device=cuda, **kw)
    assert ivf.probe_topk.launches > before[0]
    assert ivf.kmeans_update.launches == before[1] + 10
    assert copies == []
    ref_labels, ref_medoids = ann_engine.generate_clusters(
        *args, device="cpu", **kw)
    np.testing.assert_array_equal(labels, ref_labels)
    np.testing.assert_array_equal(medoids, ref_medoids)


@pytest.fixture(scope="module")
def mesh_rows():
    """~1,300 spectra in 3 m/z (rows in three 512-row shards, bands across
    their edges), 30 of them twice."""
    spectra, _ = make_clustered_spectra(
        n_clusters=150, cluster_size=6, n_noise=450, seed=13, charges=(2,),
        precursor_mz_range=(600.0, 603.0))
    out = [process_spectrum(s, 5, 250, 101.0, 1500.0, 1.5, 0.01, 50, None)
           for s in spectra]
    out = [r for r in out if r is not None]
    return out + [dict(r, identifier=r["identifier"] + "_copy")
                  for r in out[1::9][:30]]


def _mesh_dataset(rows, tmp_path):
    store = SpectrumStore(str(tmp_path / "spectra"))
    writer = store.writer()
    writer.add_many(rows)
    writer.close()
    return (store.dataset(2), 0.1, 2, 0, 20.0, "ppm", None, TOL, 2**15)


@pytest.mark.parametrize("case", ["linkage", "dbscan", "rerank_off_dbscan"])
def test_sharded_pipeline_on_four_shards_of_the_card(cuda, mesh_rows,
                                                     tmp_path, monkeypatch,
                                                     case):
    # [cuda:0] x 4: the sharded chain's labels equal one device's (and its
    # medoids, apart from dbscan mode's hashed ones), and the sharded chain
    # on the card equals it on the CPU bit for bit, medoids included.
    monkeypatch.setenv(VIRTUAL_DEVICES_ENV, "4")
    args = _mesh_dataset(mesh_rows, tmp_path)
    kw = {"linkage": {}, "dbscan": dict(cluster_method="dbscan"),
          "rerank_off_dbscan": dict(cluster_method="dbscan",
                                    rerank="off")}[case]
    counts = (vz.vectorize, pw.pair_list_scores, md.segment_sums,
              md.segment_dots, md.hashed_medoid_scores)
    before = [c.launches for c in counts]
    labels, medoids = ann_engine.generate_clusters(*args, devices=4,
                                                   device=cuda, **kw)
    launched = [c.launches - b for c, b in zip(counts, before)]
    cpu = ann_engine.generate_clusters(*args, devices=4, device="cpu", **kw)
    one = ann_engine.generate_clusters(*args, device=cuda, **kw)
    np.testing.assert_array_equal(labels, cpu[0])
    np.testing.assert_array_equal(medoids, cpu[1])
    np.testing.assert_array_equal(labels, one[0])
    if case != "dbscan":
        np.testing.assert_array_equal(medoids, one[1])
    assert launched == {"linkage": [4, 4, 0, 0, 0],
                        "dbscan": [4, 4, 4, 4, 0],
                        "rerank_off_dbscan": [1, 0, 0, 0, 1]}[case]


@pytest.mark.parametrize("devices", [None, 2])
def test_pipelined_blocks_equal_serial_blocks(cuda, mesh_rows, tmp_path,
                                              monkeypatch, devices):
    monkeypatch.setenv("FALCON_TPU_DEVICE_BLOCK_CAP", "256")
    if devices:
        monkeypatch.setenv(VIRTUAL_DEVICES_ENV, str(devices))
    args = _mesh_dataset(mesh_rows, tmp_path)
    out, gauge = {}, {}
    for depth in ("1", "2"):
        monkeypatch.setenv("FALCON_TPU_BLOCK_PIPELINE", depth)
        profiler.start_recording()
        try:
            out[depth] = ann_engine.generate_clusters(
                *args, devices=devices, device=cuda)
        finally:
            profiler.stop_recording()
        gauge[depth] = profiler.counters()["ann.blocks_in_flight.max"]
    np.testing.assert_array_equal(out["1"][0], out["2"][0])
    np.testing.assert_array_equal(out["1"][1], out["2"][1])
    assert gauge["2"] >= 2
    assert gauge["1"] == (1 if devices is None else 2)


def test_pair_list_launch_from_a_worker_thread(cuda, rows):
    # The launcher runs on the calling thread's current device and stream:
    # a worker under worker_stream launches on its own stream.
    mz, intensity = _padded(rows, cuda)
    gen = torch.Generator(device="cpu").manual_seed(5)
    ids = torch.randint(0, mz.shape[0], (200, 64), generator=gen)
    ids[torch.rand(ids.shape, generator=gen) < 0.3] = -1
    args = (mz[:200], intensity[:200], mz, intensity, ids.to(cuda), TOL, 4)
    want = pw.pair_list_scores(*args)
    torch.cuda.synchronize()

    def work():
        with worker_stream(cuda):
            stream = torch.cuda.current_stream(cuda)
            got = pw.pair_list_scores(*args)
        return got, stream

    with ThreadPoolExecutor(2) as pool:
        results = [f.result() for f in [pool.submit(work) for _ in range(2)]]
    for got, stream in results:
        assert stream != torch.cuda.default_stream(cuda)
        _assert_same(got, want)


def test_halo_pool_rerank_bit_identical_to_plain(cuda, rows):
    # Queries and the pool apart, as on a shard of the sharded pipeline.
    mz, intensity = _padded(rows, cuda)
    pool_mz = torch.cat([mz[300:], mz[:300]])
    pool_int = torch.cat([intensity[300:], intensity[:300]])
    gen = torch.Generator(device="cpu").manual_seed(2)
    ids = torch.randint(0, pool_mz.shape[0], (200, 45), generator=gen)
    ids[torch.rand(ids.shape, generator=gen) < 0.3] = -1
    ids = ids.to(cuda)
    q = (mz[100:300], intensity[100:300])
    before = pw.pair_list_scores.launches
    got = rerank.rerank_exact(*q, ids, TOL, 16, pool=(pool_mz, pool_int))
    torch.cuda.synchronize()
    assert pw.pair_list_scores.launches == before + 1
    plain = rerank.rerank_scan_body(*q, pool_mz, pool_int, ids, TOL, 16)
    cpu = rerank.rerank_exact(q[0].cpu(), q[1].cpu(), ids.cpu(), TOL, 16,
                              pool=(pool_mz.cpu(), pool_int.cpu()))
    for a, b, c in zip(got, plain, cpu):
        assert torch.equal(a, b) and torch.equal(a.cpu(), c)


def test_sharded_medoid_scores_bit_identical_to_cpu(cuda, mesh_rows):
    # B.2's sums and dots alone, per shard, against their plain versions,
    # and the sharded scores on [cuda:0] x 4 against the CPU's.
    mz, intensity = _padded(mesh_rows, cuda)
    n = mz.shape[0]
    hasher = vz.SpectrumHasher(101.0, 1500.0, TOL)
    vectors = vz.normalize_rows(hasher.vectorize(
        torch.nn.functional.pad(mz, (0, 0, 0, 2048 - n), value=pw.PAD_MZ),
        torch.nn.functional.pad(intensity, (0, 0, 0, 2048 - n)),
        norm=False))
    rng = np.random.default_rng(4)
    seg = rng.integers(0, 300, n).astype(np.int32)
    seg[::7] = 299  # a large segment
    cuda_mesh = mesh.Mesh((cuda,) * 4)
    cpu_mesh = mesh.Mesh((torch.device("cpu"),) * 4)
    parts = mesh.shard_rows(cuda_mesh, vectors)
    seg_full = torch.zeros(2048, dtype=torch.int32)
    seg_full[:n] = torch.from_numpy(seg)
    for v, s in zip(parts, mesh.shard_rows(cuda_mesh, seg_full.to(cuda))):
        sums = md.segment_sums(v, s, 512)
        assert torch.equal(sums, md.segment_sums_plain(v, s, 512))
        dots = md.segment_dots(v, s, sums, 512)
        assert torch.equal(dots, md.segment_dots_plain(v, s, sums, 512))
    got = sharded_pipeline.sharded_medoid_scores(parts, seg, 300, cuda_mesh)
    want = sharded_pipeline.sharded_medoid_scores(
        [p.cpu() for p in parts], seg, 300, cpu_mesh)
    assert got.tobytes() == want.tobytes()


def _sorted_host(rows):
    rows = sorted(rows, key=lambda r: r["precursor_mz"])
    mz, intensity = _padded(rows, "cpu")
    return (mz.numpy(), intensity.numpy(),
            np.asarray([r["precursor_mz"] for r in rows]),
            np.asarray([r["retention_time"] for r in rows]))


@pytest.mark.parametrize("min_matches", [0, 6])
def test_sharded_exact_slices_on_four_shards(cuda, mesh_rows, monkeypatch,
                                             min_matches):
    # [cuda:0] x 4: each shard's condensed slice through K1 (first and last
    # rows cut) equals the slices through K1's plain version on the card
    # and the one-device distances, bit for bit, twice.
    from falcon_tpu_torch.parallel import sharded_exact

    mz, intensity, _, _ = _sorted_host(mesh_rows[:700])
    m = mesh.Mesh((cuda,) * 4)
    args = (mz, intensity, TOL, min_matches, m)
    before = pw.panel_scores.launches
    got = sharded_exact.condensed_distances_sharded(*args, panel_rows=128)
    assert pw.panel_scores.launches - before >= 7  # panels of 128 rows
    again = sharded_exact.condensed_distances_sharded(*args, panel_rows=128)
    one = pw.condensed_distances(mz, intensity, TOL, min_matches, rounds=8,
                                 device=cuda)
    monkeypatch.setattr(sharded_exact, "panel_scores", pw.panel_scores_plain)
    plain = sharded_exact.condensed_distances_sharded(*args, panel_rows=128)
    assert got.tobytes() == again.tobytes() == plain.tobytes()
    assert got.tobytes() == one.tobytes()


def test_exact_backend_on_four_shards_equals_one_device(cuda, mesh_rows,
                                                        tmp_path,
                                                        monkeypatch):
    monkeypatch.setenv(VIRTUAL_DEVICES_ENV, "4")
    store = SpectrumStore(str(tmp_path / "spectra"))
    writer = store.writer()
    writer.add_many(mesh_rows[:500])
    writer.close()
    args = (store.dataset(2), "complete", 0.1, 0, 20.0, "ppm", None, TOL,
            2**15)
    before = pw.panel_scores.launches
    got = engine.generate_clusters(*args, devices=4, device=cuda,
                                   panel_only=True)
    assert pw.panel_scores.launches > before
    one = engine.generate_clusters(*args, device=cuda)
    cpu = engine.generate_clusters(*args, devices=4, device="cpu",
                                   panel_only=True)
    for a, b, c in zip(got, one, cpu):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("rt_tol,min_matches", [(None, 0), (300.0, 4)])
def test_sharded_exact_index_on_four_shards(cuda, mesh_rows, monkeypatch,
                                            rt_tol, min_matches):
    # The windowed halo pair lists: the pair-list kernel against each
    # shard's halo pool equals its plain version and the CPU, bit for bit.
    from falcon_tpu_torch.parallel import sharded_exact_index as sei

    mz, intensity, pmz, rts = _sorted_host(mesh_rows)
    args = (mz, intensity, pmz, 20.0, "ppm", 16, TOL)
    kw = dict(rts=rts if rt_tol else None, rt_tol=rt_tol,
              min_matches=min_matches)
    before = pw.pair_list_scores.launches
    got = sei.exact_banded_topk_sharded(*args, mesh.Mesh((cuda,) * 4), **kw)
    assert pw.pair_list_scores.launches == before + 4
    cpu = sei.exact_banded_topk_sharded(
        *args, mesh.Mesh((torch.device("cpu"),) * 4), **kw)
    monkeypatch.setattr(pw, "pair_list_scores", pw.pair_list_scores_plain)
    plain = sei.exact_banded_topk_sharded(*args, mesh.Mesh((cuda,) * 4),
                                          **kw)
    for a, b, c in zip(got, plain, cpu):
        assert a.device.type == "cuda"
        assert torch.equal(a, b) and torch.equal(a.cpu(), c)
    assert int((got[1] >= 0).sum()) > 3 * len(pmz)


@pytest.mark.parametrize("ann_index", ["exact", "ivf"])
def test_sharded_indexes_on_four_shards_of_the_card(cuda, mesh_rows,
                                                    tmp_path, monkeypatch,
                                                    ann_index):
    # --ann_index exact: one device's labels and medoids; ivf: the CPU's
    # sharded labels and medoids (the ring's tie order is the JAX
    # package's sharded one).
    from falcon_tpu_torch.ops import ivf

    monkeypatch.setenv(VIRTUAL_DEVICES_ENV, "4")
    args = _mesh_dataset(mesh_rows, tmp_path)
    counts = (pw.pair_list_scores, ivf.probe_topk)
    before = [c.launches for c in counts]
    got = ann_engine.generate_clusters(*args, devices=4, device=cuda,
                                       ann_index=ann_index)
    launched = [c.launches - b for c, b in zip(counts, before)]
    cpu = ann_engine.generate_clusters(*args, devices=4, device="cpu",
                                       ann_index=ann_index)
    for a, c in zip(got, cpu):
        np.testing.assert_array_equal(a, c)
    if ann_index == "exact":
        one = ann_engine.generate_clusters(*args, device=cuda,
                                           ann_index="exact")
        for a, b in zip(got, one):
            np.testing.assert_array_equal(a, b)
        assert launched[0] >= 4
    else:
        assert launched[1] >= 16  # 4 shards x 4 ring steps


@pytest.mark.parametrize("precise", [False, True], ids=["bf16", "f32"])
def test_ivf_probe_topk_masked_probes_bit_identical_to_plain(
        cuda, ivf_block, precise):
    # A ring step's launch: the corpus is one block of lists plus a list
    # of +inf m/z for the probes outside it.
    from falcon_tpu_torch.ops import ivf

    index, _ = _ivf_index(cuda, ivf_block, precise)
    n_probe, lb = 32, index._lb
    layout = _probe_layout(index, cuda, n_probe)
    s_lists = index.n_lists // 4
    probes = layout[6]
    lo = 2 * s_lists
    held = (probes >= lo) & (probes < lo + s_lists)
    local = torch.where(held, probes - lo, s_lists).int().contiguous()
    block = [torch.cat([a[lo:lo + s_lists], a.new_full((1,) + a.shape[1:],
                                                       fill)])
             for a, fill in ((layout[3], 0.0), (layout[4], torch.inf),
                             (layout[5], -1))]
    chunk = ivf.scan_chunk(index.n_lists, lb, n_probe, lb)
    before = ivf.probe_topk.launches
    for c0 in range(0, index.n_lists, chunk):
        args = layout[:3] + tuple(block) + (local, 20.0, False, 256, c0,
                                             chunk)
        got, again = ivf.probe_topk(*args), ivf.probe_topk(*args)
        want = ivf.probe_topk_plain(*args)
        for g, a, w in zip(got, again, want):
            assert torch.equal(g, w) and torch.equal(g, a)
        # Kept slots lie in the held block.
        kept = got[1][got[1] >= 0]
        assert bool((kept < s_lists * lb).all())
    assert ivf.probe_topk.launches == before + 2 * (index.n_lists // chunk)


@pytest.mark.parametrize("precise", [False, True], ids=["bf16", "f32"])
def test_ivf_ring_bit_identical_to_plain_ring(cuda, ivf_block, monkeypatch,
                                              precise):
    from falcon_tpu_torch.ops import ivf
    from falcon_tpu_torch.parallel import sharded_ivf

    index, _ = _ivf_index(cuda, ivf_block, precise)
    m = mesh.Mesh((cuda,) * 4)
    args = (index, 256, 32, 20.0, "ppm", m)
    before = ivf.probe_topk.launches
    got = sharded_ivf.ivf_search_sharded(*args, precise=precise)
    assert ivf.probe_topk.launches - before >= 16
    monkeypatch.setattr(sharded_ivf, "probe_topk", ivf.probe_topk_plain)
    plain = sharded_ivf.ivf_search_sharded(*args, precise=precise)
    for g, p in zip(got, plain):
        assert g.device.type == "cuda" and torch.equal(g, p)
    # The same neighbour sets as the one-device search, where separated.
    one = index.self_search(256, 32, 20.0, "ppm", precise=precise)
    assert torch.equal(got[0], one[0])
    assert int((got[1] >= 0).sum()) > 0
