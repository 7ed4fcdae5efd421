"""The port's plain matching ops (``falcon_tpu_torch.ops.matching``)
against the JAX package's (``falcon_tpu.ops.matching``) on the CPU.

Inputs are made with numpy from a seed and handed to both.  Weights,
selections and match counts must agree exactly; scores to 1e-6, since the
two packages add the selected weights in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from falcon_tpu.ops import matching as jm
from falcon_tpu.preprocess import process_spectrum
from falcon_tpu.simulate import make_clustered_spectra
from falcon_tpu.store.store import padded_peaks
from falcon_tpu_torch.ops import matching as tm

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
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=ATOL,
                               rtol=0)
    assert s_t.dtype == torch.float32 and m_t.dtype == torch.int32

    p_t, pm_t = tm.pair_scores(_t(mz_a), _t(int_a), _t(mz_b), _t(int_b),
                               TOL, rounds)
    p_j, pm_j = jm.pair_scores(jnp.asarray(mz_a), jnp.asarray(int_a),
                               jnp.asarray(mz_b), jnp.asarray(int_b), TOL,
                               rounds)
    np.testing.assert_array_equal(pm_t.numpy(), np.asarray(pm_j))
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=ATOL,
                               rtol=0)


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
        np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=ATOL,
                                   rtol=0)
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
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=ATOL,
                               rtol=0)
    # Symmetric up to the order in which the columns are added.
    np.testing.assert_allclose(s_t.numpy(), s_t.numpy().T, atol=ATOL,
                               rtol=0)
