"""The port's exact banded k-NN (``falcon_tpu_torch.ops.exact_knn``) against
the JAX package's on the CPU.

On a CPU tensor the banded kernel's wrapper (K2) runs its plain version;
the JAX side runs ``_banded_panel_pallas`` in interpret mode, as the JAX
package's own tests do, or its XLA path.  Scores agree to 1e-6 (the
packages add the selected weights in different orders) and match counts
exactly.  Neighbour ids agree row by row, except inside a run of scores
equal to within 1e-6, where they are compared as sets.  The inputs are
made from seeds with numpy; one of them holds every spectrum twice, so
ties are real.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from falcon_tpu.ops import exact_knn as jx
from falcon_tpu.ops import knn as jknn
from falcon_tpu.ops.rerank import rerank_scan_body
from falcon_tpu.preprocess import process_spectrum
from falcon_tpu.simulate import make_clustered_spectra
from falcon_tpu.store.store import padded_peaks
from falcon_tpu_torch.ops import exact_knn as tx
from falcon_tpu_torch.ops import knn as tknn
from falcon_tpu_torch.ops import pairwise as tp

TOL = 0.05
ATOL = 1e-6
N_PAD = 512


def _sorted_block(duplicate: bool = False, seed: int = 33):
    """(mz_pad, int_pad) (512, 64), sorted precursor m/z and RTs of ~160
    spectra whose precursors crowd into 1 m/z."""
    spectra, _ = make_clustered_spectra(
        n_clusters=20, cluster_size=6, n_noise=40, seed=seed, charges=(2,),
        precursor_mz_range=(600.0, 601.0))
    rows = [process_spectrum(s, 5, 250, 101.0, 1500.0, 1.5, 0.01, 50, None)
            for s in spectra]
    rows = [r for r in rows if r is not None]
    if duplicate:
        rows = rows[:75] + rows[:75]
    offsets = np.zeros(len(rows) + 1, np.int64)
    offsets[1:] = np.cumsum([len(r["mz"]) for r in rows])
    mz, intensity, _ = padded_peaks(
        offsets, np.concatenate([r["mz"] for r in rows]),
        np.concatenate([r["intensity"] for r in rows]), 64)
    pmz = np.asarray([r["precursor_mz"] for r in rows])
    rts = np.asarray([r["retention_time"] for r in rows])
    order = np.argsort(pmz, kind="stable")
    n = len(rows)
    mz_pad = np.full((N_PAD, 64), -1e6, np.float32)
    int_pad = np.zeros((N_PAD, 64), np.float32)
    mz_pad[:n], int_pad[:n] = mz[order], intensity[order]
    return mz_pad, int_pad, pmz[order], rts[order]


@pytest.fixture(scope="module")
def block():
    return _sorted_block()


@pytest.fixture(scope="module")
def dup_block():
    return _sorted_block(duplicate=True, seed=8)


def _assert_topk_equal(got_s, got_i, want_s, want_i):
    got_s, got_i = np.asarray(got_s), np.asarray(got_i)
    want_s, want_i = np.asarray(want_s), np.asarray(want_i)
    assert got_s.shape == want_s.shape
    np.testing.assert_allclose(got_s, want_s, atol=ATOL, rtol=0)
    for r in range(want_s.shape[0]):
        s = want_s[r]
        start = 0
        for j in range(1, len(s) + 1):
            if j == len(s) or abs(s[j] - s[start]) > ATOL:
                assert (sorted(got_i[r, start:j].tolist())
                        == sorted(want_i[r, start:j].tolist())), (r, start)
                start = j


@pytest.mark.parametrize("tol,mode", [(20.0, "ppm"), (500.0, "ppm"),
                                      (0.05, "Da"), (2.0, "Da")])
def test_window_layout_and_band_bounds_match_jax(block, tol, mode):
    pmz = block[2]
    for got, want in zip(tknn.band_bounds(pmz, tol, mode == "Da"),
                         jknn.band_bounds(pmz, tol, mode == "Da")):
        np.testing.assert_array_equal(got, want)
    for n_pad in (N_PAD, 4096):
        starts, window = tx.window_layout(pmz, tol, mode, n_pad)
        want_starts, want_window = jx.window_layout(pmz, tol, mode, n_pad)
        assert window == want_window
        assert starts.dtype == np.int32
        np.testing.assert_array_equal(starts, want_starts)


@pytest.mark.parametrize("pass_offset", [0, 128])
def test_banded_panel_plain_vs_pallas_interpret(block, pass_offset):
    # 16 rows of the 500 ppm layout (a 256-column window); the second
    # case scores its second 128-column pass, which the Pallas kernel
    # reaches through starts shifted by one tile.
    mz_pad, int_pad, pmz, _ = block
    starts, window = tx.window_layout(pmz, 500.0, "ppm", N_PAD)
    assert window == 256
    r0, r1 = 40, 56
    width = window - pass_offset
    ours, ours_m = tx.banded_panel_scores(
        torch.from_numpy(mz_pad[r0:r1]), torch.from_numpy(int_pad[r0:r1]),
        torch.from_numpy(mz_pad), torch.from_numpy(int_pad),
        torch.from_numpy(starts[r0:r1]), pass_offset, width, TOL, 4)
    ref, ref_m = jx._banded_panel_pallas(
        jnp.asarray(mz_pad[r0:r1]), jnp.asarray(int_pad[r0:r1]),
        jnp.asarray(mz_pad), jnp.asarray(int_pad),
        jnp.asarray(starts[r0:r1] + pass_offset // tx.COL_TILE), width,
        TOL, 4, True, interpret=True)
    assert ours.shape == (r1 - r0, width) and ours_m.dtype == torch.int32
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)
    np.testing.assert_array_equal(ours_m.numpy(), np.asarray(ref_m))
    assert (ours.numpy() > 0).any()


def _jax_topk(data, backend, tol=500.0, k=8, min_matches=0, rt_tol=None):
    mz_pad, int_pad, pmz, rts = data
    return jx.exact_banded_topk(
        jnp.asarray(mz_pad), jnp.asarray(int_pad), pmz, tol, "ppm", k, TOL,
        rts=rts if rt_tol is not None else None, rt_tol=rt_tol,
        min_matches=min_matches, backend=backend)


# The tie-heavy case also zeroes low match counts and cuts by RT.
CASES = {"plain": {}, "ties": dict(min_matches=4, rt_tol=600.0)}


@pytest.fixture(scope="module")
def jax_xla_topk(block, dup_block):
    return {"plain": _jax_topk(block, "xla"),
            "ties": _jax_topk(dup_block, "xla", **CASES["ties"])}


@pytest.mark.parametrize("pass_width", [None, 128],
                         ids=["single_pass", "two_passes"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_exact_banded_topk_vs_jax_xla(block, dup_block, jax_xla_topk, case,
                                      pass_width):
    mz_pad, int_pad, pmz, rts = block if case == "plain" else dup_block
    opts = CASES[case]
    sims, ids = tx.exact_banded_topk(
        torch.from_numpy(mz_pad), torch.from_numpy(int_pad), pmz, 500.0,
        "ppm", 8, TOL, rts=rts if "rt_tol" in opts else None,
        block_rows=64, pass_width=pass_width, **opts)
    assert sims.shape == ids.shape == (N_PAD, 8)
    assert ids.dtype == torch.int64
    want_s, want_i = jax_xla_topk[case]
    _assert_topk_equal(sims, ids, want_s, want_i)
    n = len(pmz)
    assert (ids[n:] == -1).all() and (sims[n:] == tknn.NEG).all()
    assert (ids[:n] >= 0).any()


def test_exact_banded_topk_vs_pallas_interpret(block):
    mz_pad, int_pad, pmz, _ = block
    want_s, want_i = _jax_topk(block, "pallas_interpret", tol=20.0)
    sims, ids = tx.exact_banded_topk(
        torch.from_numpy(mz_pad), torch.from_numpy(int_pad), pmz, 20.0,
        "ppm", 8, TOL)
    _assert_topk_equal(sims, ids, want_s, want_i)


def test_topk_order_matches_lax_top_k():
    # Quantised values tie often; lax.top_k puts the lower position first.
    rng = np.random.default_rng(0)
    a = rng.integers(0, 4, (32, 40)).astype(np.float32) / 4
    b = rng.integers(0, 4, (32, 40)).astype(np.float32) / 4
    ia = rng.permutation(32 * 40).reshape(32, 40)
    ib = rng.permutation(32 * 40).reshape(32, 40)
    top, pos = tknn.stable_topk(torch.from_numpy(a), 12)
    want, want_pos = jax.lax.top_k(jnp.asarray(a), 12)
    np.testing.assert_array_equal(top.numpy(), np.asarray(want))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want_pos))
    # The merge keeps the first pair's entry on a tie.
    got_s, got_i = tknn.merge_topk(*(torch.from_numpy(x)
                                     for x in (a, ia, b, ib)), 16)
    want_s, want_i = jknn._merge_topk(*(jnp.asarray(x)
                                        for x in (a, ia, b, ib)), 16)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def test_pair_list_scores_vs_jax_rerank(block):
    # Each of 64 query rows against 24 pool ids, a third of them -1.
    mz_pad, int_pad, _, _ = block
    rng = np.random.default_rng(1)
    q0 = 30
    ids = rng.integers(0, 150, (64, 24))
    ids[rng.random(ids.shape) < 0.3] = -1
    scores, matches = tp.pair_list_scores(
        torch.from_numpy(mz_pad[q0:q0 + 64]),
        torch.from_numpy(int_pad[q0:q0 + 64]), torch.from_numpy(mz_pad),
        torch.from_numpy(int_pad), torch.from_numpy(ids), TOL, 4)
    ref_s, ref_i, ref_m = rerank_scan_body(
        jnp.asarray(mz_pad[q0:q0 + 64]), jnp.asarray(int_pad[q0:q0 + 64]),
        jnp.asarray(mz_pad), jnp.asarray(int_pad),
        jnp.asarray(ids, jnp.int32), TOL, 24, 4, 64, 8)
    ref_s, ref_i, ref_m = (np.asarray(x) for x in (ref_s, ref_i, ref_m))
    scores, matches = scores.numpy(), matches.numpy()
    assert ((ids < 0) == (scores == tknn.NEG)).all()
    assert (matches[ids < 0] == 0).all()
    for r in range(64):
        got = {int(c): (s, m) for c, s, m in zip(ids[r], scores[r],
                                                 matches[r]) if c >= 0}
        want = {int(c): (s, m) for c, s, m in zip(ref_i[r], ref_s[r],
                                                  ref_m[r]) if c >= 0}
        assert sorted(got) == sorted(want)
        for c in got:
            assert abs(got[c][0] - want[c][0]) <= ATOL
            assert got[c][1] == want[c][1]


def test_cpu_tensors_take_the_plain_versions(block):
    mz_pad, int_pad, pmz, _ = block
    args = [torch.from_numpy(a) for a in (mz_pad[:8], int_pad[:8], mz_pad,
                                          int_pad)]
    starts = torch.zeros(8, dtype=torch.int32)
    ids = torch.arange(40).reshape(8, 5)
    before = (tx.banded_panel_scores.launches, tp.pair_list_scores.launches)
    s, m = tx.banded_panel_scores(*args, starts, 0, 128, TOL, 4)
    ref_s, ref_m = tx.banded_panel_scores_plain(*args, starts, 0, 128, TOL,
                                                4)
    assert torch.equal(s, ref_s) and torch.equal(m, ref_m)
    s, m = tp.pair_list_scores(*args, ids, TOL, 4, with_matches=False)
    assert m is None and torch.equal(
        s, tp.pair_list_scores_plain(*args, ids, TOL, 4)[0])
    assert (tx.banded_panel_scores.launches,
            tp.pair_list_scores.launches) == before


@pytest.mark.parametrize("bad", ["window_past_pool", "negative_start",
                                 "starts_int64", "id_past_pool"])
def test_wrappers_reject_bad_inputs(block, bad):
    mz_pad, int_pad, _, _ = block
    args = [torch.from_numpy(a) for a in (mz_pad[:8], int_pad[:8],
                                          mz_pad[:256], int_pad[:256])]
    starts = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        if bad == "window_past_pool":
            tx.banded_panel_scores(*args, starts + 1, 0, 256, TOL, 4)
        elif bad == "negative_start":
            tx.banded_panel_scores(*args, starts - 1, 0, 128, TOL, 4)
        elif bad == "starts_int64":
            tx.banded_panel_scores(*args, starts.long(), 0, 128, TOL, 4)
        else:
            tp.pair_list_scores(*args, torch.full((8, 3), 256), TOL, 4)
