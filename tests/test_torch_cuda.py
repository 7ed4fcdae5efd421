"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: every test skips where ``torch.cuda.is_available()`` is
false (a CUDA kernel has no CPU or interpret mode).  On a machine with an
NVIDIA Hopper GPU and nvcc::

    python -m pytest -m cuda tests/test_torch_cuda.py

The kernels and their plain versions add the selected weights in the same
order, so scores must agree to 1e-6 and match counts exactly; the engine
must give identical labels and medoids through the kernels on the GPU and
through the plain versions on the CPU.
"""

import numpy as np
import pytest
import torch

from falcon_tpu.preprocess import process_spectrum
from falcon_tpu.simulate import make_clustered_spectra
from falcon_tpu.store.store import SpectrumStore, padded_peaks
from falcon_tpu_torch.cluster import ann_engine, engine
from falcon_tpu_torch.ops import exact_knn as ex
from falcon_tpu_torch.ops import pairwise as pw

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
    args = (store.dataset(2), 0.2, 0, 20.0, "ppm", None, TOL, 2**15)
    before = (ex.banded_panel_scores.launches, pw.pair_list_scores.launches,
              pw.panel_scores.launches)
    labels, medoids = ann_engine.generate_clusters(*args, linkage=linkage,
                                                   device=cuda)
    after = (ex.banded_panel_scores.launches, pw.pair_list_scores.launches,
             pw.panel_scores.launches)
    ref_labels, ref_medoids = ann_engine.generate_clusters(
        *args, linkage=linkage, device="cpu")
    np.testing.assert_array_equal(labels, ref_labels)
    np.testing.assert_array_equal(medoids, ref_medoids)
    assert after[0] > before[0]
    assert after[1 if linkage == "complete" else 2] > before[
        1 if linkage == "complete" else 2]
