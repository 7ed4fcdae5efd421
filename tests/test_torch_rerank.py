"""The port's exact rerank (``ops/rerank.py``) against the JAX package's
``rerank_exact(..., as_device=True)`` on the CPU: the same candidate lists
give identical ids and match counts and scores within 1e-6, through the
pair-list scorer and a stable top-k.

The lists hold -1 holes, rows with no candidate, fewer or more slots than
``k_out`` and a width that is no multiple of the JAX package's 16-slot
chunks; tie-heavy spectra (each present twice) make exact-score ties that
must go to the lower slot.  Inputs are made from seeds with numpy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from falcon_tpu.ops import rerank as jrerank
from falcon_tpu.preprocess import process_spectrum
from falcon_tpu.simulate import make_clustered_spectra
from falcon_tpu.store.store import padded_peaks
from falcon_tpu_torch.ops import rerank
from falcon_tpu_torch.ops.knn import NEG
from torch_cases import PAD_MZ, tie_heavy

TOL = 0.05
ATOL = 1e-6


def _clustered(n_pad):
    spectra, _ = make_clustered_spectra(
        n_clusters=40, cluster_size=5, n_noise=60, seed=9, charges=(2,),
        precursor_mz_range=(800.0, 800.5))
    rows = [r for r in (process_spectrum(s, 5, 250, 101.0, 1500.0, 1.5,
                                         0.01, 50, None) for s in spectra)
            if r is not None]
    offsets = np.zeros(len(rows) + 1, np.int64)
    offsets[1:] = np.cumsum([len(r["mz"]) for r in rows])
    mz, intensity, _ = padded_peaks(
        offsets, np.concatenate([r["mz"] for r in rows]),
        np.concatenate([r["intensity"] for r in rows]), 64)
    return _pad_rows(mz, intensity, n_pad)


def _pad_rows(mz, intensity, n_pad):
    out_mz = np.full((n_pad, 64), PAD_MZ, np.float32)
    out_int = np.zeros((n_pad, 64), np.float32)
    out_mz[:len(mz)], out_int[:len(mz)] = mz, intensity
    return out_mz, out_int, len(mz)


def _lists(n, n_pad, width, seed, holes=0.3):
    """Candidate ids near each row (as a band scan finds them), -1 holes,
    padded rows and every 13th row empty."""
    rng = np.random.default_rng(seed)
    ids = np.arange(n)[:, None] + rng.integers(-40, 41, (n, width))
    ids[(ids < 0) | (ids >= n) | (rng.random(ids.shape) < holes)] = -1
    ids[::13] = -1
    out = np.full((n_pad, width), -1, np.int64)
    out[:n] = ids
    return out


@pytest.mark.parametrize("case,width,k_out", [
    ("clustered", 37, 16), ("clustered", 8, 64), ("tie_heavy", 48, 24)])
def test_rerank_exact_matches_jax(case, width, k_out):
    if case == "clustered":
        mz, intensity, n = _clustered(512)
    else:
        mz, intensity, n = _pad_rows(*tie_heavy(150, seed=4), 512)
    neigh = _lists(n, 512, width, seed=width)
    ours = rerank.rerank_exact(torch.from_numpy(mz),
                               torch.from_numpy(intensity),
                               torch.from_numpy(neigh), TOL, k_out)
    ref = jrerank.rerank_exact(jnp.asarray(mz), jnp.asarray(intensity),
                               jnp.asarray(neigh, jnp.int32), TOL, k_out,
                               as_device=True)
    scores, ids, matches = (t.numpy() for t in ours)
    ref_scores, ref_ids, ref_matches = (np.asarray(a) for a in ref)
    assert scores.shape == ref_scores.shape == (512, min(k_out, width))
    assert ids.dtype == np.int64 and matches.dtype == np.int32
    np.testing.assert_allclose(scores, ref_scores, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(ids, ref_ids)
    # The JAX package leaves a missing slot's count at whatever its
    # placeholder pair gave; the port's is 0.
    real = ids >= 0
    np.testing.assert_array_equal(matches[real], ref_matches[real])
    assert (matches[~real] == 0).all() and (scores[~real] == NEG).all()
    assert real.sum() > n and (scores[real] > 0).any()
    # The plain version is the same computation on the same device.
    plain = rerank.rerank_scan_body(
        torch.from_numpy(mz), torch.from_numpy(intensity),
        torch.from_numpy(mz), torch.from_numpy(intensity),
        torch.from_numpy(neigh), TOL, k_out)
    for a, b in zip(ours, plain):
        assert torch.equal(a, b)
