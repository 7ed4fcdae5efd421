"""The port's pair scorers (``falcon_tpu_torch.ops.pairwise``) against the
JAX package's on the CPU.

On a CPU tensor each wrapper runs its kernel's plain version; the JAX side
runs the Pallas panel kernel in interpret mode, as the JAX package's own
tests do, and its XLA ``batched_block_scores``.  Distances and scores agree
to 1e-6 (the packages add the selected weights in different orders); match
counts exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from falcon_tpu.ops import pairwise as jp
from falcon_tpu.preprocess import process_spectrum
from falcon_tpu.simulate import make_clustered_spectra
from falcon_tpu.store.store import padded_peaks
from falcon_tpu_torch.ops import pairwise as tp
from torch_cases import permuted, tie_heavy

TOL = 0.05
ATOL = 1e-6


@pytest.fixture(scope="module")
def padded_dataset():
    spectra, _ = make_clustered_spectra(
        n_clusters=12, cluster_size=4, n_noise=20, seed=3
    )
    rows = []
    for s in spectra:
        out = process_spectrum(s, 5, 250, 101.0, 1500.0, 1.5, 0.01, 50, None)
        if out is not None:
            rows.append(out)
    offsets = np.zeros(len(rows) + 1, np.int64)
    offsets[1:] = np.cumsum([len(r["mz"]) for r in rows])
    mz_flat = np.concatenate([r["mz"] for r in rows])
    int_flat = np.concatenate([r["intensity"] for r in rows])
    mz, intensity, _ = padded_peaks(offsets, mz_flat, int_flat, 64)
    return mz, intensity


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


@pytest.mark.parametrize("min_matches", [0, 6])
def test_condensed_distances_vs_pallas_interpret(padded_dataset,
                                                 min_matches):
    mz, intensity = padded_dataset
    sub = 40
    ours = tp.condensed_distances(mz[:sub], intensity[:sub], TOL,
                                  min_matches=min_matches, panel_rows=16,
                                  device="cpu")
    ref = jp.condensed_distances(mz[:sub], intensity[:sub], TOL,
                                 min_matches=min_matches,
                                 backend="pallas_interpret", panel_rows=16)
    assert ours.dtype == np.float32 and ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("upper_only", [False, True])
def test_panel_scores_row_offset_vs_pallas_interpret(padded_dataset,
                                                     upper_only):
    # A 16-row panel starting at global row 12 against 40 columns: the
    # diagonal runs through the middle of the panel.
    mz, intensity = padded_dataset
    r0, r1, n = 12, 28, 40
    ours, ours_m = tp.panel_scores(
        _t(mz[r0:r1]), _t(intensity[r0:r1]), _t(mz[:n]), _t(intensity[:n]),
        r0, TOL, upper_only=upper_only,
    )
    cols = 64  # the Pallas kernel takes whole column tiles
    ref, ref_m = jp.panel_scores_pallas(
        jnp.asarray(mz[r0:r1]), jnp.asarray(intensity[r0:r1]),
        jnp.asarray(jp._pad_rows(mz[:n], cols, jp.PAD_MZ)),
        jnp.asarray(jp._pad_rows(intensity[:n], cols, 0.0)),
        jnp.int32(r0), TOL, upper_only=upper_only, interpret=True,
        tile_j=cols,
    )
    ref, ref_m = np.asarray(ref)[:, :n], np.asarray(ref_m)[:, :n]
    ours, ours_m = ours.numpy(), ours_m.numpy()
    upper = (np.arange(n)[None, :] > (r0 + np.arange(r1 - r0))[:, None])
    keep = upper if upper_only else np.ones_like(upper)
    np.testing.assert_allclose(ours[keep], ref[keep], atol=ATOL, rtol=0)
    np.testing.assert_array_equal(ours_m[keep], ref_m[keep])
    # Pairs outside the requested triangle are never scored.
    assert (ours[~keep] == 0).all() and (ours_m[~keep] == 0).all()


def test_panel_scores_without_matches(padded_dataset):
    mz, intensity = padded_dataset
    args = (_t(mz[:8]), _t(intensity[:8]), _t(mz[:20]), _t(intensity[:20]),
            0, TOL)
    with_m, matches = tp.panel_scores(*args, upper_only=True)
    without, none = tp.panel_scores(*args, upper_only=True,
                                    with_matches=False)
    assert none is None and matches.dtype == torch.int32
    assert torch.equal(with_m, without)


def _intervals(sizes, seed=5):
    spectra, _ = make_clustered_spectra(
        n_clusters=25, cluster_size=8, n_noise=120, seed=seed
    )
    rows = [process_spectrum(s, 5, 250, 101.0, 1500.0, 1.5, 0.01, 50, None)
            for s in spectra]
    rows = [r for r in rows if r is not None]
    offsets = np.zeros(len(rows) + 1, np.int64)
    offsets[1:] = np.cumsum([len(r["mz"]) for r in rows])
    mz, intensity, _ = padded_peaks(
        offsets, np.concatenate([r["mz"] for r in rows]),
        np.concatenate([r["intensity"] for r in rows]), 64)
    rng = np.random.default_rng(seed)
    out = []
    for m in sizes:
        idx = rng.choice(mz.shape[0], size=m, replace=False)
        out.append((mz[idx], intensity[idx]))
    return out


SIZES = [1, 2, 3, 9, 17, 33, 70, 5, 64, 12]


@pytest.mark.parametrize("min_matches", [0, 6])
def test_grouped_condensed_distances_vs_jax(min_matches):
    peaks = _intervals(SIZES)
    # A small pair budget splits the intervals over several launches.
    ours = dict(tp.grouped_condensed_distances(
        peaks, TOL, min_matches=min_matches, max_group_pairs=3000,
        device="cpu"))
    ref = dict(jp.grouped_condensed_distances(peaks, TOL,
                                              min_matches=min_matches))
    assert sorted(ours) == sorted(ref) == list(range(len(SIZES)))
    for k, m in enumerate(SIZES):
        assert ours[k].dtype == np.float32
        assert ours[k].shape == ref[k].shape == (m * (m - 1) // 2,)
        np.testing.assert_allclose(ours[k], ref[k], atol=ATOL, rtol=0)


# K4's cases: spectra as the store keeps them, tie-heavy ones, peaks in no
# m/z order, and wide fragment tolerances (many peak pairs per column).
GROUPED_CASES = ["plain", "tie_heavy", "permuted", "tol_0.5", "tol_2.0"]


@pytest.mark.parametrize("case", GROUPED_CASES)
def test_batched_block_scores_vs_jax(case):
    # The port takes ragged intervals; the JAX op takes them padded to one
    # size.  Both must give the same upper-triangle scores and counts.
    sizes = [7, 16, 2, 11]
    peaks = _intervals(sizes, seed=9)
    if case == "tie_heavy":
        mz, intensity = tie_heavy(sum(sizes) // 2, seed=4)
        bounds = np.cumsum([0] + sizes)
        peaks = [(mz[a:b], intensity[a:b])
                 for a, b in zip(bounds[:-1], bounds[1:])]
    elif case == "permuted":
        peaks = [permuted(mz, intensity, seed=g)
                 for g, (mz, intensity) in enumerate(peaks)]
    tol = float(case[4:]) if case.startswith("tol_") else TOL
    m_pad = 16
    mz_g = np.full((len(sizes), m_pad, 64), jp.PAD_MZ, np.float32)
    int_g = np.zeros((len(sizes), m_pad, 64), np.float32)
    for g, (mz, intensity) in enumerate(peaks):
        mz_g[g, :len(mz)] = mz
        int_g[g, :len(mz)] = intensity
    ref_s, ref_m = jp.batched_block_scores(jnp.asarray(mz_g),
                                           jnp.asarray(int_g), tol)
    ref_s, ref_m = np.asarray(ref_s), np.asarray(ref_m)

    starts = torch.tensor(np.concatenate([[0], np.cumsum(sizes)]))
    ours_s, ours_m = tp.batched_block_scores(
        _t(np.concatenate([p[0] for p in peaks])),
        _t(np.concatenate([p[1] for p in peaks])), starts, tol,
    )
    want_s = np.concatenate([ref_s[g][np.triu_indices(m, 1)]
                             for g, m in enumerate(sizes)])
    want_m = np.concatenate([ref_m[g][np.triu_indices(m, 1)]
                             for g, m in enumerate(sizes)])
    np.testing.assert_allclose(ours_s.numpy(), want_s, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(ours_m.numpy(), want_m)
    assert (want_m > 0).any()


@pytest.mark.parametrize("sizes", [
    [], [0], [1], [2], [0, 1, 2, 0], [33], [3, 70, 1, 32, 65, 2],
], ids=str)
def test_grouped_items_cover_every_pair_once(sizes):
    # K4's work items, each found from _grouped_layout as a warp of
    # grouped_kernel (csrc/pairwise.cu) finds its own: the last interval
    # whose first item is <= t, then the last row whose first item is <= t.
    # They cover each condensed pair of each interval, at its place in the
    # concatenated condensed order, exactly once, with at most 32 columns
    # an item, all in the row's interval and to its right.
    w = tp.ITEM_COLS
    bounds = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    layout = tp._grouped_layout(bounds)
    assert layout.dtype == np.int64 and layout.shape == (2, len(sizes) + 1)
    want = [(a + i, a + j) for a, b in zip(bounds[:-1], bounds[1:])
            for i, j in zip(*np.triu_indices(b - a, 1))]
    assert layout[1, -1] == len(want)

    def tail(k):  # items of an interval's last k rows, counted row by row
        return sum(-(-c // w) for c in range(k))

    assert list(layout[0]) == [0] + list(np.cumsum(
        [tail(b - a) for a, b in zip(bounds[:-1], bounds[1:])], dtype=int))
    got = [None] * len(want)
    for t in range(int(layout[0, -1])):
        g = int(np.searchsorted(layout[0], t, side="right")) - 1
        first, m = int(bounds[g]), int(bounds[g + 1] - bounds[g])
        u = t - int(layout[0, g])
        r = max(r for r in range(m) if tail(m) - tail(m - r) <= u)
        chunk = u - (tail(m) - tail(m - r))
        i, j0 = first + r, first + r + 1 + w * chunk
        j_end = min(j0 + w, first + m)
        o = int(layout[1, g]) + r * (m - 1) - r * (r - 1) // 2 + w * chunk
        assert i < j0 < j_end <= first + m
        for c in range(j_end - j0):
            assert got[o + c] is None
            got[o + c] = (i, j0 + c)
    assert got == want


def test_grouped_layout_refuses_oversized_intervals():
    bounds = np.array([0, 5, 5 + tp.MAX_INTERVAL + 1], np.int64)
    with pytest.raises(ValueError, match="more than"):
        tp._grouped_layout(bounds)
    assert tp._grouped_layout(bounds[:2])[1, -1] == 10


def test_cpu_tensors_take_the_plain_version(padded_dataset):
    mz, intensity = padded_dataset
    before = (tp.panel_scores.launches, tp.batched_block_scores.launches)
    s, m = tp.panel_scores(_t(mz[:4]), _t(intensity[:4]), _t(mz[:9]),
                           _t(intensity[:9]), 0, TOL)
    ref_s, ref_m = tp.panel_scores_plain(_t(mz[:4]), _t(intensity[:4]),
                                         _t(mz[:9]), _t(intensity[:9]), 0,
                                         TOL)
    assert torch.equal(s, ref_s) and torch.equal(m, ref_m)
    tp.batched_block_scores(_t(mz[:9]), _t(intensity[:9]),
                            torch.tensor([0, 4, 9]), TOL)
    # Launch counters count kernel launches only.
    assert (tp.panel_scores.launches,
            tp.batched_block_scores.launches) == before


@pytest.mark.parametrize("bad", ["float64", "non_contiguous", "rank",
                                 "shape", "starts"])
def test_wrappers_reject_bad_inputs(padded_dataset, bad):
    mz, intensity = (_t(a[:8]) for a in padded_dataset)
    starts = torch.tensor([0, 3, 8])
    if bad == "float64":
        mz = mz.double()
    elif bad == "non_contiguous":
        mz = mz.t().contiguous().t()
    elif bad == "rank":
        mz = mz[None]
    elif bad == "shape":
        intensity = intensity[:, :32].contiguous()
    else:
        starts = torch.tensor([0, 5, 4, 8])
    with pytest.raises((TypeError, ValueError)):
        if bad == "starts":
            tp.batched_block_scores(mz, intensity, starts, TOL)
        else:
            tp.panel_scores(mz, intensity, mz, intensity, 0, TOL)


@pytest.mark.parametrize("starts,match", [
    ([0, 5, 4, 8], "rise from 0"),     # not rising
    ([1, 4, 8], "rise from 0"),        # not from 0
    ([0, 4, 7], "rise from 0 to 8"),   # not to n
    ([0, 4, 9], "rise from 0 to 8"),   # past n
    ([0.0, 4.0, 8.0], "int64"),        # wrong dtype
    ([8], ">= 2 offsets"),             # too short
    ([[0, 4, 8]], "1-D"),              # wrong rank
])
def test_grouped_scores_check_starts_on_one_host_copy(padded_dataset, starts,
                                                      match, monkeypatch):
    # The checks read one host copy of ``starts`` (one sync on the card)
    # and refuse every malformed table the device-side checks refused.
    mz, intensity = (_t(a[:8]) for a in padded_dataset)
    bad = torch.tensor(starts)
    copies = []
    real_cpu = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu",
                        lambda t: copies.append(1) or real_cpu(t))
    with pytest.raises(ValueError, match=match):
        tp.batched_block_scores(mz, intensity, bad, TOL)
    assert len(copies) <= 1
    good = tp._check_starts("K4", torch.tensor([0, 3, 3, 8]), 8,
                            torch.device("cpu"))
    np.testing.assert_array_equal(good, [0, 3, 3, 8])
