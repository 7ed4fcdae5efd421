"""Inputs that make the port's kernels work hard, for the
``tests/test_torch_*.py`` files, made with numpy from a seed: spectra as
(n, 64) float32 m/z and intensity with padding m/z -1e6 and intensity 0,
sparse neighbour lists for the medoid scores, and peaks for the consensus
table.  Numpy only, so the card's tests can use them without JAX."""

import numpy as np

PAD_MZ = -1e6


def tie_heavy(n: int, seed: int):
    """(mz, intensity) (2 n, 64): peaks crowded into a few tolerance windows
    with quantised intensities, in no m/z order, each spectrum twice
    (duplicates tie everywhere)."""
    rng = np.random.default_rng(seed)
    mz = np.full((n, 64), PAD_MZ, np.float32)
    intensity = np.zeros((n, 64), np.float32)
    for i in range(n):
        k = int(rng.integers(4, 64))
        mz[i, :k] = (rng.choice([200.0, 200.03, 350.0, 500.0], size=k)
                     + rng.choice([0.0, 0.01, 0.02], size=k))
        intensity[i, :k] = rng.choice([0.25, 0.5], size=k)
    return np.repeat(mz, 2, axis=0), np.repeat(intensity, 2, axis=0)


def permuted(mz: np.ndarray, intensity: np.ndarray, seed: int):
    """Each spectrum's 64 peaks, padding included, in a random order."""
    perm = np.argsort(np.random.default_rng(seed).random(mz.shape), axis=1)
    return (np.take_along_axis(mz, perm, 1),
            np.take_along_axis(intensity, perm, 1))


def medoid_lists(n, n_pad, k, seed):
    """Sparse lists of ``n`` rows padded to ``n_pad``: ids near the row
    (so many edges are mutual), -1 slots, quantised similarities (some
    negative), clusters with noise in the spill segment, and rows 0..9
    duplicates of rows 10..19.  Returns (sims, neigh, seg, n_seg)."""
    rng = np.random.default_rng(seed)
    n_seg = max(n // 6, 2)
    seg = rng.integers(0, n_seg + 1, n).astype(np.int32)  # n_seg: spill
    seg[:10] = seg[10:20]
    neigh = np.full((n_pad, k), -1, np.int64)
    sims = np.full((n_pad, k), -2.0, np.float32)
    for i in range(n):
        ids = rng.integers(max(0, i - 30), min(n, i + 30), k)
        ids[(rng.random(k) < 0.2) | (ids == i)] = -1
        neigh[i] = ids
        sims[i] = np.where(
            ids >= 0, rng.choice([0.95, 0.9, 0.5, -0.1, 1 / 3], k)
            * rng.choice([1.0, 0.999], k), -2.0)
    for a in range(10):
        neigh[a], sims[a] = neigh[a + 10], sims[a + 10]
        neigh[a][neigh[a] == a] = a + 10
    return sims, neigh, seg, n_seg + 1


def consensus_peaks(n, seed):
    """(key, member, m/z, intensity): few keys and members, so runs are
    long and one member often has several peaks in one bin."""
    rng = np.random.default_rng(seed)
    key = rng.integers(0, max(n // 40, 2), n).astype(np.int32)
    member = rng.integers(0, 6, n).astype(np.int32)
    mz = rng.uniform(100.0, 1500.0, n).astype(np.float32)
    intensity = (rng.random(n) * rng.choice([1.0, 1e-3, 1e2], n)
                 ).astype(np.float32)
    return key, member, mz, intensity


def medoid_hub_lists(n, n_pad, k, seed):
    """``medoid_lists`` with one large cluster (rows 20..1300, n > 1450)
    whose rows all list row 1400 in slot 0 (an in-degree of 1,281, above
    a warp's 1,024) and rows 20..99 also row 1450 in slot 1 (80, above 32);
    neither hub lists them back, so every such edge counts."""
    sims, neigh, seg, n_seg = medoid_lists(n, n_pad, k, seed)
    big = np.arange(20, 1301)
    seg[big] = 0
    seg[[1400, 1450]] = 0
    neigh[big, 0] = 1400
    sims[big, 0] = np.where(big % 3 == 0, 0.7, 1 / 3)
    neigh[20:100, 1] = 1450
    sims[20:100, 1] = 0.9
    for hub in (1400, 1450):
        neigh[hub][(neigh[hub] >= 20) & (neigh[hub] <= 1300)] = -1
    return sims, neigh, seg, n_seg


def consensus_skewed(n, seed, case):
    """``consensus_peaks`` with skew: ``hot_key`` gives half the peaks one
    key (a bucket longer than a warp sorts in shared memory);
    ``one_bucket`` puts every key in [2**20, 2**20 + 64), which the
    kernel's buckets of high key bits hold in one bucket."""
    key, member, mz, intensity = consensus_peaks(n, seed)
    if case == "hot_key":
        key[::2] = 7
    else:
        key = (2**20 + np.random.default_rng(seed).integers(0, 64, n)
               ).astype(np.int32)
    return key, member, mz, intensity


# Group-by inputs (key, n_groups, shift) and the tiers (small, warp, long)
# each reaches, for ops/groupby.py's kernels and the tests' mirror of them.
GROUPBY_CASES = {
    "small_groups": ((3000, 1000, 0), (True, False, False)),
    "hub_warp": ((3000, 1000, 0), (True, True, False)),
    "hub_long": ((4000, 1000, 0), (True, True, True)),
    "one_group": ((1500, 1, 0), (False, False, True)),
    "sinks_and_shift": ((3000, 200, 4), (True, True, False)),
    "sparse_groups": ((500, 100000, 0), (True, False, False)),
}


def groupby_keys(case: str, seed: int):
    """(key int32 (n,), n_groups, shift) of a GROUPBY_CASES case."""
    (n, n_groups, shift), _ = GROUPBY_CASES[case]
    rng = np.random.default_rng(seed)
    key = rng.integers(0, n_groups << shift, n)
    if case == "hub_warp":
        key[rng.random(n) < 0.2] = 17  # ~600 items in group 17
    elif case == "hub_long":
        key[rng.random(n) < 0.5] = 3  # ~2,000 items in group 3
        key[:100] = 900  # and 100 in group 900
    elif case == "one_group":
        key[:] = 0
    elif case == "sinks_and_shift":
        key[rng.random(n) < 0.1] = -5  # negative: dropped
        key[rng.random(n) < 0.1] = n_groups << shift  # past the end
        key[:300] = (12 << shift) + rng.integers(0, 1 << shift, 300)
    elif case == "sparse_groups":
        key[:5] = 42  # most groups empty, a few of one item, one of 5+
    return key.astype(np.int32), n_groups, shift


def tiers_reached(sizes, warp_cap: int, small: int = 16):
    """(any group sorted by one thread, by a warp, by a block) of the
    group sizes, as the kernels pick them."""
    sizes = np.asarray(sizes)
    return (bool(((sizes > 1) & (sizes <= small)).any()),
            bool(((sizes > small) & (sizes <= warp_cap)).any()),
            bool((sizes > warp_cap).any()))
