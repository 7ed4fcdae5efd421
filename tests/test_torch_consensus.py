"""The port's consensus spectra (``falcon_tpu_torch/ops/consensus.py``)
against the JAX package's, on the CPU.

``aggregate`` sorts the peaks by (cluster-bin key, member) and sums each
key's run in sorted order, as XLA does on the CPU, so its table equals the
JAX package's bit for bit: keys, intensity sums, intensity-weighted m/z
sums (printed into the MGF) and distinct member counts, with many peaks of
one member in one bin (whose input order the stable sort keeps).
``consensus_spectra`` then gives the same peaks, bit for bit.  Inputs are
made from seeds with numpy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from falcon_tpu.ops import consensus as jax_consensus
from falcon_tpu.simulate import make_clustered_spectra
from falcon_tpu_torch.ops import consensus
from torch_cases import consensus_peaks, consensus_skewed


@pytest.mark.parametrize("n", [1, 37, 4096, 20000])
def test_aggregate_matches_jax(n):
    arrays = consensus_peaks(n, seed=n)
    ref = jax_consensus._get_aggregate()(*(jnp.asarray(a) for a in arrays))
    n_keys = int(ref[4])
    before = consensus.aggregate.launches
    got = consensus.aggregate(*(torch.from_numpy(a) for a in arrays))
    assert consensus.aggregate.launches == before
    plain = consensus.aggregate_plain(*(torch.from_numpy(a)
                                        for a in arrays))
    assert len(got) == 4 and got[0].shape == (n_keys,)
    for g, p, r in zip(got, plain, ref[:4]):
        assert torch.equal(g, p)
        np.testing.assert_array_equal(g.numpy(), np.asarray(r)[:n_keys])


@pytest.mark.parametrize("n,case", [(4096, "hot_key"), (200, "one_bucket"),
                                    (5000, "one_bucket")])
def test_aggregate_skewed_matches_jax(n, case):
    # A key of 2,048 peaks (a bucket the kernel orders in global memory),
    # and every peak in one bucket (a warp's sort at 200, a block's at
    # 5,000).
    arrays = consensus_skewed(n, n, case)
    ref = jax_consensus._get_aggregate()(*(jnp.asarray(a) for a in arrays))
    n_keys = int(ref[4])
    got = consensus.aggregate(*(torch.from_numpy(a) for a in arrays))
    assert got[0].shape == (n_keys,)
    for g, r in zip(got, ref[:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r)[:n_keys])
    if case == "hot_key":
        assert int(got[3][got[0] == 7]) == 6  # every member in the hot key


def _ragged(rng, n_rows):
    lengths = rng.integers(1, 40, n_rows)
    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    mz = rng.uniform(150.0, 1400.0, offsets[-1])
    # Near-duplicate peaks: many members share bins, and some peaks of one
    # spectrum fall in one bin.
    mz = np.round(mz / 0.5) * 0.5 + rng.choice([0.0, 0.01, 0.02],
                                                offsets[-1])
    intensity = rng.random(offsets[-1]).astype(np.float32)
    return offsets, mz.astype(np.float32), intensity


@pytest.mark.parametrize("case", ["defaults", "min_fraction_0.9_max_5",
                                  "filter"])
def test_consensus_spectra_match_jax(case):
    rng = np.random.default_rng(len(case))
    offsets, mz, intensity = _ragged(rng, 300)
    labels = rng.integers(0, 40, 300)
    kw = dict(min_fraction=0.5, max_peaks=50)
    if case == "min_fraction_0.9_max_5":
        kw = dict(min_fraction=0.9, max_peaks=5)
    elif case == "filter":
        kw["cluster_filter"] = np.arange(0, 40, 3)
    args = (offsets, mz, intensity, labels, 0.05, 101.0)
    got = consensus.consensus_spectra(*args, device="cpu", **kw)
    want = jax_consensus.consensus_spectra(*args, **kw)
    assert sorted(got) == sorted(want) and len(got) > 5
    for label in want:
        for g, w in zip(got[label], want[label]):
            assert g.dtype == np.float32
            np.testing.assert_array_equal(g, w)


def test_consensus_spectra_of_simulated_clusters():
    # Real cluster structure: members share most peaks.
    spectra, labels = make_clustered_spectra(n_clusters=12, cluster_size=5,
                                             n_noise=0, seed=8)
    offsets = np.concatenate([[0], np.cumsum([len(s.mz) for s in spectra])])
    mz = np.concatenate([s.mz for s in spectra]).astype(np.float32)
    intensity = np.concatenate([s.intensity for s in spectra]
                               ).astype(np.float32)
    args = (offsets, mz, intensity, np.asarray(labels), 0.05, 101.0)
    got = consensus.consensus_spectra(*args, device="cpu")
    want = jax_consensus.consensus_spectra(*args)
    assert sorted(got) == sorted(want) == list(range(12))
    for label in want:
        for g, w in zip(got[label], want[label]):
            np.testing.assert_array_equal(g, w)


def test_aggregate_rejects_bad_inputs():
    key, member, mz, intensity = (torch.from_numpy(a)
                                  for a in consensus_peaks(10, 1))
    with pytest.raises(ValueError, match="int32"):
        consensus.aggregate(key.long(), member, mz, intensity)
    with pytest.raises(ValueError, match="no peaks"):
        consensus.aggregate(key[:0], member[:0], mz[:0], intensity[:0])
