"""The port's banded upper-bound scan (``ops/knn.py::knn_banded``) against
the JAX package's ``knn_banded(..., as_device=True, exact_topk=True)`` on
the CPU.

Inputs are hashed vectors of a simulated corpus (made from a seed) whose
precursors crowd into 1 m/z, so bands span hundreds of columns.  Scores
agree to 1e-6 (the float32 sums run in another order); ids are identical
wherever a score differs from its neighbours in the list by more than
that, and so are the padded rows and the RT holes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from falcon_tpu.ops import knn as jknn
from falcon_tpu.ops.vectorize import SpectrumHasher as JaxHasher
from falcon_tpu.preprocess import process_spectrum
from falcon_tpu.simulate import make_clustered_spectra
from falcon_tpu.store.store import padded_peaks
from falcon_tpu_torch.ops import knn

ATOL = 1e-6


@pytest.fixture(scope="module")
def corpus():
    """(sorted precursor m/z, RTs, {"plain", "spread", "unit"} vectors) of
    ~600 spectra, the vectors from the JAX hasher."""
    spectra, _ = make_clustered_spectra(
        n_clusters=60, cluster_size=6, n_noise=250, seed=5, charges=(2,),
        precursor_mz_range=(700.0, 701.0))
    rows = [r for r in (process_spectrum(s, 5, 250, 101.0, 1500.0, 1.5,
                                         0.01, 50, None) for s in spectra)
            if r is not None]
    rows.sort(key=lambda r: r["precursor_mz"])
    offsets = np.zeros(len(rows) + 1, np.int64)
    offsets[1:] = np.cumsum([len(r["mz"]) for r in rows])
    mz, intensity, _ = padded_peaks(
        offsets, np.concatenate([r["mz"] for r in rows]),
        np.concatenate([r["intensity"] for r in rows]), 64)
    hasher = JaxHasher(101.0, 1500.0, 0.05, 200, 0)
    vec = {}
    for name, kw in (("plain", dict(norm=False)),
                     ("spread", dict(norm=False, spread=True)),
                     ("unit", dict(norm=True))):
        vec[name] = np.array(hasher.vectorize(
            jnp.asarray(mz), jnp.asarray(intensity), **kw))
    pmz = np.asarray([r["precursor_mz"] for r in rows])
    rts = np.random.default_rng(5).uniform(0.0, 3600.0, len(rows))
    return pmz, rts, vec


def _assert_lists_agree(ours, ref, n):
    scores, ids = (t.numpy() for t in ours)
    ref_scores, ref_ids = np.asarray(ref[0]), np.asarray(ref[1])
    assert scores.shape == ref_scores.shape and ids.dtype == np.int64
    np.testing.assert_allclose(scores, ref_scores, atol=ATOL, rtol=0)
    gap = np.full(scores.shape, np.inf)
    gap[:, 1:] = np.minimum(gap[:, 1:], np.abs(np.diff(scores, axis=1)))
    gap[:, :-1] = np.minimum(gap[:, :-1], np.abs(np.diff(scores, axis=1)))
    distinct = gap > ATOL
    np.testing.assert_array_equal(ids[distinct], ref_ids[distinct])
    np.testing.assert_array_equal(ids < 0, ref_ids < 0)
    assert (ids[n:] == -1).all() and (scores[n:] == knn.NEG).all()
    assert (ids[:n] >= 0).any()


@pytest.mark.parametrize("case", ["f32_symmetric", "bf16_spread",
                                  "bf16_spread_rt", "column_passes"])
def test_knn_banded_matches_jax(corpus, case, monkeypatch):
    pmz, rts, vec = corpus
    kw = dict(tol_mass=20.0, tol_mode="ppm", k=16, block_rows=256)
    cols, queries, bf16, sub = vec["unit"], None, False, None
    if case.startswith("bf16"):
        cols, queries, bf16 = vec["plain"], vec["spread"], True
        kw["k"] = 48
    if case.endswith("_rt"):
        kw.update(rts=rts, rt_tol=900.0)
    if case == "column_passes":
        # A 500 ppm band: a window of 512 columns in passes of 128.
        kw.update(tol_mass=500.0, k=64)
        sub = 128
        monkeypatch.setenv("FALCON_TPU_KNN_COL_CHUNK", str(sub))
    ours = knn.knn_banded(
        torch.from_numpy(cols), pmz, q_vectors=None if queries is None
        else torch.from_numpy(queries), scan_bf16=bf16, sub_window=sub,
        **kw)
    ref = jknn.knn_banded(cols, pmz, as_device=True, exact_topk=True,
                          q_vectors=queries, scan_bf16=bf16, **kw)
    _assert_lists_agree(ours, ref, len(pmz))
    if case.endswith("_rt"):
        # The RT filter punches holes into the bound-sorted lists.
        ids = ours[1].numpy()[:len(pmz)]
        assert ((ids[:, :-1] < 0) & (ids[:, 1:] >= 0)).any()


def test_passes_and_block_sizes_do_not_change_the_lists(corpus,
                                                        monkeypatch):
    pmz, rts, vec = corpus
    args = (torch.from_numpy(vec["plain"]), pmz, 300.0, "ppm", 40)
    kw = dict(rts=rts, rt_tol=1200.0,
              q_vectors=torch.from_numpy(vec["spread"]), scan_bf16=True)
    want = knn.knn_banded(*args, **kw)
    # A 1 KiB tile: the row block halves to 512 rows, then the window
    # splits into passes.
    monkeypatch.setattr(knn, "TILE_BYTES", 1024)
    got = knn.knn_banded(*args, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    starts, block_rows, window, n_pad = knn.block_geometry(
        *knn.band_bounds(pmz, 300.0, False), len(pmz), 1024)
    assert (block_rows, n_pad) == (512, 1024) and window >= 512
    assert (starts + window <= n_pad).all()


@pytest.mark.parametrize("api", ["precision", "legacy", "matmul_precision"])
def test_refuse_tf32_reads_either_api(api):
    # No GPU is touched: the guard reads only the backend flags.  Setting
    # TF32 through the precision API and then reading the legacy flag
    # raises PyTorch's own "mix of the legacy and new APIs" error.
    matmul = torch.backends.cuda.matmul
    saved = getattr(matmul, "fp32_precision", None)
    cuda = torch.device("cuda")
    try:
        if api == "precision":
            if saved is None:
                pytest.skip("this torch has no fp32_precision API")
            matmul.fp32_precision = "tf32"
        elif api == "legacy":
            matmul.allow_tf32 = True
        else:
            torch.set_float32_matmul_precision("high")
        with pytest.raises(RuntimeError, match="x needs full float32"):
            knn.refuse_tf32("x", cuda)
        knn.refuse_tf32("x", torch.device("cpu"))
        if saved is not None:
            matmul.fp32_precision = "ieee"
        else:
            matmul.allow_tf32 = False
        knn.refuse_tf32("x", cuda)
    finally:
        torch.set_float32_matmul_precision("highest")
        if saved is not None:
            matmul.fp32_precision = saved
        else:
            matmul.allow_tf32 = False


def test_knn_banded_rejects_mismatched_vectors(corpus):
    pmz, _, vec = corpus
    plain = torch.from_numpy(vec["plain"])
    with pytest.raises(ValueError, match="float32"):
        knn.knn_banded(plain.double(), pmz, 20.0, "ppm", 8)
    with pytest.raises(ValueError, match="one shape"):
        knn.knn_banded(plain, pmz, 20.0, "ppm", 8, q_vectors=plain[:, :128])
