"""The port's plain matching ops (``falcon_tpu_torch.ops.matching``)
against the JAX package's (``falcon_tpu.ops.matching``) on the CPU.

Inputs are made with numpy from a seed and handed to both.  Weights,
selections, match counts and scores must agree bit for bit: the port adds
the selected weights in the order XLA's CPU backend gives the JAX
package's ``match_score`` (``falcon_tpu_torch/ops/matching.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from falcon_tpu.ops import matching as jm
from falcon_tpu.preprocess import process_spectrum
from falcon_tpu.simulate import make_clustered_spectra
from falcon_tpu.store.store import padded_peaks
from falcon_tpu_torch.cluster.oracle import cosine_exact
from falcon_tpu_torch.ops import matching as tm
from torch_cases import unambiguous

TOL = 0.05
# Symmetry of the port's own block scores: (i, j) and (j, i) add the
# blocks in another order.
SYM_ATOL = 1e-6


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


def _tie_heavy(n: int, seed: int):
    """Padded spectra whose peaks crowd into a few tolerance windows with
    quantised intensities, so equal weights and equal row / column maxima
    are common."""
    rng = np.random.default_rng(seed)
    mz = np.full((n, 64), -1e6, np.float32)
    intensity = np.zeros((n, 64), np.float32)
    for i in range(n):
        k = int(rng.integers(4, 40))
        centres = rng.choice([200.0, 200.03, 350.0, 500.0], size=k)
        mz[i, :k] = centres + rng.choice([0.0, 0.01, 0.02], size=k)
        intensity[i, :k] = rng.choice([0.25, 0.5], size=k)
    return mz, intensity


def _pairs(kind: str):
    """(mz_a, int_a, mz_b, int_b) batches of spectrum pairs."""
    rng = np.random.default_rng(7)
    if kind == "random":
        spectra, _ = make_clustered_spectra(
            n_clusters=6, cluster_size=4, n_noise=10, seed=5
        )
        rows = [process_spectrum(s, 5, 250, 101.0, 1500.0, 1.5, 0.01, 50,
                                 None) for s in spectra]
        rows = [r for r in rows if r is not None]
        offsets = np.zeros(len(rows) + 1, np.int64)
        offsets[1:] = np.cumsum([len(r["mz"]) for r in rows])
        mz, intensity, _ = padded_peaks(
            offsets, np.concatenate([r["mz"] for r in rows]),
            np.concatenate([r["intensity"] for r in rows]), 64)
    else:
        mz, intensity = _tie_heavy(24, seed=11)
    idx = rng.integers(0, mz.shape[0], size=(96, 2))
    # Duplicated spectra: a pair of a spectrum with itself ties everywhere.
    idx[:8, 1] = idx[:8, 0]
    return (mz[idx[:, 0]], intensity[idx[:, 0]], mz[idx[:, 1]],
            intensity[idx[:, 1]])


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("kind", ["random", "tie_heavy"])
def test_pair_weights_exact(kind):
    mz_a, int_a, mz_b, int_b = _pairs(kind)
    ours = tm.pair_weights(_t(mz_a), _t(int_a), _t(mz_b), _t(int_b), TOL)
    ref = jm.pair_weights(jnp.asarray(mz_a), jnp.asarray(int_a),
                          jnp.asarray(mz_b), jnp.asarray(int_b), TOL)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_pair_weights_tolerance_edge_in_float32():
    # 0.05 is not exact in float32: a difference that lies between the f32
    # and the f64 value of the tolerance separates the two comparisons.
    mz_a = np.full((1, 64), -1e6, np.float32)
    mz_b = np.full((1, 64), -1e6, np.float32)
    int_a = np.zeros((1, 64), np.float32)
    int_b = np.zeros((1, 64), np.float32)
    mz_a[0, :2] = [100.0, 300.0]
    mz_b[0, :2] = [np.float32(100.0) + np.float32(0.05), 300.05]
    int_a[0, :2] = int_b[0, :2] = 0.5
    ours = tm.pair_weights(_t(mz_a), _t(int_a), _t(mz_b), _t(int_b), TOL)
    ref = jm.pair_weights(jnp.asarray(mz_a), jnp.asarray(int_a),
                          jnp.asarray(mz_b), jnp.asarray(int_b), TOL)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("axis", [-1, -2])
def test_first_true_exact(axis):
    rng = np.random.default_rng(1)
    mask = rng.random((5, 64, 64)) < 0.1
    ours = tm._first_true(torch.from_numpy(mask), axis)
    ref = jm._first_true(jnp.asarray(mask), axis)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("kind", ["random", "tie_heavy"])
def test_match_rounds_body_exact(kind):
    mz_a, int_a, mz_b, int_b = _pairs(kind)
    w = np.array(jm.pair_weights(jnp.asarray(mz_a), jnp.asarray(int_a),
                                 jnp.asarray(mz_b), jnp.asarray(int_b),
                                 TOL))
    w_t, w_j = torch.from_numpy(w.copy()), jnp.asarray(w)
    for _ in range(4):  # several rounds: the surviving weights feed back
        w_t, sel_t, cand_t = tm.match_rounds_body(w_t)
        w_j, sel_j, cand_j = jm.match_rounds_body(w_j)
        np.testing.assert_array_equal(cand_t.numpy(), np.asarray(cand_j))
        np.testing.assert_array_equal(sel_t.numpy(), np.asarray(sel_j))
        np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_j))


@pytest.mark.parametrize("kind", ["random", "tie_heavy"])
@pytest.mark.parametrize("rounds", [1, 2, 8, 32])
def test_match_score_and_pair_scores(kind, rounds):
    mz_a, int_a, mz_b, int_b = _pairs(kind)
    w = np.array(jm.pair_weights(jnp.asarray(mz_a), jnp.asarray(int_a),
                                 jnp.asarray(mz_b), jnp.asarray(int_b),
                                 TOL))
    s_t, m_t = tm.match_score(torch.from_numpy(w), rounds)
    s_j, m_j = jm.match_score(jnp.asarray(w), rounds)
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    assert s_t.dtype == torch.float32 and m_t.dtype == torch.int32

    p_t, pm_t = tm.pair_scores(_t(mz_a), _t(int_a), _t(mz_b), _t(int_b),
                               TOL, rounds)
    p_j, pm_j = jm.pair_scores(jnp.asarray(mz_a), jnp.asarray(int_a),
                               jnp.asarray(mz_b), jnp.asarray(int_b), TOL,
                               rounds)
    np.testing.assert_array_equal(pm_t.numpy(), np.asarray(pm_j))
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))


def test_match_score_stops_at_the_round_cap():
    # A path of rising weights (r0-c0, r0-c1, r1-c1, r1-c2, ...): each round
    # takes only the heaviest edge left, so the cap decides the count.
    w = np.zeros((1, 64, 64), np.float32)
    for t in range(12):
        w[0, t // 2, (t + 1) // 2] = 0.01 * (t + 1)
    counts = []
    for rounds in (0, 1, 3, 8):
        s_t, m_t = tm.match_score(torch.from_numpy(w), rounds)
        s_j, m_j = jm.match_score(jnp.asarray(w), rounds)
        np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
        np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
        counts.append(int(m_t[0]))
    assert counts == [0, 1, 3, 6]


def test_block_scores_vs_xla(padded_dataset):
    mz, intensity = padded_dataset
    sub = 24
    s_t, m_t = tm.block_scores(_t(mz[:sub]), _t(intensity[:sub]), TOL,
                               pair_chunk=100)
    s_j, m_j = jm.block_scores_xla(jnp.asarray(mz[:sub]),
                                   jnp.asarray(intensity[:sub]), TOL)
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    # Symmetric up to the order in which the blocks are added.
    np.testing.assert_allclose(s_t.numpy(), s_t.numpy().T, atol=SYM_ATOL,
                               rtol=0)


def _one_round(p: int, entries):
    """(1, p, p) weights holding ``entries`` ((row, col, value), one per row
    and per column), so the first round selects every one of them."""
    w = np.zeros((1, p, p), np.float32)
    for r, c, v in entries:
        w[0, r, c] = v
    return w


def _sequential(values):
    acc = np.float32(0)
    for v in values:
        acc = np.float32(acc + np.float32(v))
    return acc


_A, _B, _C, _D = (np.float32(v) for v in (0.375, 2.0**-25, 1.5 * 2.0**-25,
                                          2.0**-26))
# Each case: the entries of one round, and the scores that other summation
# orders would give (each must differ from the JAX package's, or the case
# would not tell the orders apart).
ORDER_CASES = {
    # One entry in each 32 x 32 block of a 64-wide tile: XLA adds
    # (B00 + B01) + (B10 + B11), neither block order from zero.
    "blocks_64": (64, [(3, 7, _A), (5, 40, _B), (36, 2, _C), (50, 60, _D)],
                  [_sequential([_A, _B, _C, _D]),
                   _sequential([_A, _C, _B, _D])]),
    # Three entries of one block whose row order is not their column
    # order: the block is summed in row-major order.
    "within_block": (64, [(0, 5, 0.5), (3, 1, 2.0**-25), (7, 0, 2.0**-25)],
                     [_sequential([2.0**-25, 2.0**-25, 0.5])]),
    # 16 blocks at a padded width of 128: each row of blocks from zero,
    # then the rows in a halving tree, (R0 + R2) + (R1 + R3).
    "blocks_128": (128, [(3, 7, _A), (40, 45, _B), (70, 80, _C),
                         (100, 120, _D)],
                   [_sequential([_A, _B, _C, _D]),
                    np.float32(np.float32(_A + _B) + np.float32(_C + _D))]),
    # 256 blocks at 512: XLA's loop adds them in row-major order, not in
    # the halving tree of the narrower tiles.
    "blocks_512": (512, [(3, 7, _A), (40, 45, _B), (70, 80, _C),
                         (100, 120, _D)],
                   [np.float32(np.float32(_A + _C) + np.float32(_B + _D))]),
}


@pytest.mark.parametrize("case", sorted(ORDER_CASES))
def test_round_sum_takes_xla_order(case):
    p, entries, other_orders = ORDER_CASES[case]
    w = _one_round(p, entries)
    s_t, m_t = tm.match_score(torch.from_numpy(w))
    s_j, m_j = jm.match_score(jnp.asarray(w))
    assert int(m_t[0]) == int(m_j[0]) == len(entries)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    for other in other_orders:
        assert np.float32(s_j[0]) != other


def _wide_pairs(seed: int, permute: bool):
    """Pairs of spectra with up to 100 peaks, padded to 128 as the ann
    engine pads ``max_peaks`` above 64, half of them near-duplicates."""
    spectra, _ = make_clustered_spectra(
        n_clusters=8, cluster_size=4, n_noise=8, seed=seed, n_peaks=(60, 120)
    )
    rows = [process_spectrum(s, 5, 250, 101.0, 1500.0, 1.5, 0.01, 100,
                             None) for s in spectra]
    rows = [r for r in rows if r is not None]
    offsets = np.zeros(len(rows) + 1, np.int64)
    offsets[1:] = np.cumsum([len(r["mz"]) for r in rows])
    mz, intensity, _ = padded_peaks(
        offsets, np.concatenate([r["mz"] for r in rows]),
        np.concatenate([r["intensity"] for r in rows]), 128)
    if permute:
        rng = np.random.default_rng(seed)
        perm = np.argsort(rng.random(mz.shape), axis=1)
        mz = np.take_along_axis(mz, perm, 1)
        intensity = np.take_along_axis(intensity, perm, 1)
    rng = np.random.default_rng(seed + 1)
    idx = rng.integers(0, mz.shape[0], size=(64, 2))
    idx[::2, 1] = idx[::2, 0] ^ 1  # cluster neighbours
    idx[:6, 1] = idx[:6, 0]  # a spectrum against itself
    idx = np.minimum(idx, mz.shape[0] - 1)
    return (mz[idx[:, 0]], intensity[idx[:, 0]], mz[idx[:, 1]],
            intensity[idx[:, 1]])


@pytest.mark.parametrize("permute", [False, True], ids=["stored", "permuted"])
def test_pair_scores_at_padded_width_128(permute):
    mz_a, int_a, mz_b, int_b = _wide_pairs(21, permute)
    assert mz_a.shape[1] == 128 and (int_a[:, 64:] > 0).any()
    s_t, m_t = tm.pair_scores(_t(mz_a), _t(int_a), _t(mz_b), _t(int_b), TOL)
    s_j, m_j = jm.pair_scores(jnp.asarray(mz_a), jnp.asarray(int_a),
                              jnp.asarray(mz_b), jnp.asarray(int_b), TOL)
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    assert (m_t > 10).any()


@pytest.mark.parametrize("seed", [0, 1])
def test_match_score_equals_the_hungarian_oracle(seed):
    # Each peak has at most one partner, so the locally-dominant matching
    # selects the optimal assignment: the port's plain scores agree with
    # the host oracle's (cluster/oracle.py, the reference's cosine_fast
    # semantics) to 1e-6, their match counts exactly.
    mz, intensity = unambiguous(24, seed)
    ii, jj = np.triu_indices(len(mz), 1)
    got, matches = tm.pair_scores(
        torch.from_numpy(mz[ii]), torch.from_numpy(intensity[ii]),
        torch.from_numpy(mz[jj]), torch.from_numpy(intensity[jj]), TOL)
    want = [cosine_exact(mz[i], intensity[i], mz[j], intensity[j], TOL)
            for i, j in zip(ii, jj)]
    np.testing.assert_allclose(got.numpy(), [w[0] for w in want], rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(matches.numpy(), [w[1] for w in want])
    assert min(w[1] for w in want) >= 1 and max(w[0] for w in want) > 0.5

