"""The fixed-order group-by under the medoid scores (B.1, B.2) and the
consensus table (B.3), on the CPU: a mirror of its kernels' steps in numpy
against
its plain version, ``ops/groupby.py::group_by_plain`` (a stable sort by
group id and a search).

The kernels (``csrc/groupby.cuh``, ``csrc/groupby.cu``) run only on the
card; what they compute is mirrored here step by step: the counts, their
scan, a fill whose atomics land in a shuffled order, and each group's
order by the tier its length picks (one thread's insertion sort, a warp's
bitonic sort in padded shared memory, a block's bitonic sort in place past
whose end nothing moves), with the kernels' own comparator indices.  The
mirror must give the stable sort's output exactly, on seeded inputs that
reach every tier; ``tests/test_torch_cuda.py`` holds the kernels to the
same plain version on the card.

The k-means update (IVF.2, ``csrc/ivf.cu``) groups its rows by list with
another fill, one that keeps row order and needs no sort: per-tile counts
of each list, their list-major scan, and a warp per tile that walks its
rows 32 at a time, ranking each row by the lower lanes of its list
(``__match_any_sync``) after the tile's running count of the list.  Its
mirror must give the stable sort's output too.
"""

import numpy as np
import pytest
import torch

from falcon_tpu_torch.ops import consensus, groupby, ivf, medoids
from torch_cases import GROUPBY_CASES, groupby_keys, tiers_reached

TOP = (2**63 - 1, 2**31 - 1)  # above every (order key, position)


def _pair(c, k, j, flip):
    """csrc/groupby.cuh bitonic_pair."""
    if flip:
        h = k >> 1
        o = c & (h - 1)
        return ((c - o) << 1) + o, ((c - o) << 1) + k - 1 - o
    o = c & (j - 1)
    a = ((c - o) << 1) + o
    return a, a + j


def _bitonic(vals, virtual):
    """sort_warp (``virtual`` False: padded with TOP) or sort_block (True:
    comparators past the end skipped) over a list of tuples."""
    n = len(vals)
    p = 2
    while p < n:
        p <<= 1
    buf = list(vals) if virtual else list(vals) + [TOP] * (p - n)
    k = 2
    while k <= p:
        j = k >> 1
        while j > 0:
            for c in range(p >> 1):
                a, b = _pair(c, k, j, j == (k >> 1))
                if virtual and b >= n:
                    continue
                if buf[b] < buf[a]:
                    buf[a], buf[b] = buf[b], buf[a]
            j >>= 1
        k <<= 1
    return buf[:n]


def _insertion(vals):
    """sort_small."""
    out = []
    for x in vals:
        j = len(out)
        out.append(x)
        while j > 0 and x < out[j - 1]:
            out[j] = out[j - 1]
            j -= 1
        out[j] = x
    return out


def _order(vals, warp_cap):
    if len(vals) <= groupby.SMALL:
        return _insertion(vals)
    return _bitonic(vals, virtual=len(vals) > warp_cap)


def _mirror(key, n_groups, shift, seed, order_key=None,
            warp_cap=groupby.WARP_CAP):
    """The kernels' steps in numpy: (off, items).  ``order_key``: what a
    position sorts by before the position itself (none: the position)."""
    group = key.astype(np.int64) >> shift
    kept = (group >= 0) & (group < n_groups)
    cnt1 = np.zeros(n_groups + 1, np.int64)
    np.add.at(cnt1, group[kept] + 1, 1)  # step 1: counts, any order
    off = np.cumsum(cnt1)  # step 2: the scan
    items = np.full(int(off[-1]), -1, np.int64)
    for i in np.random.default_rng(seed).permutation(np.flatnonzero(kept)):
        g = group[i]  # step 3: the atomics land in a shuffled order
        cnt1[g + 1] -= 1
        items[off[g] + cnt1[g + 1]] = i
    assert (cnt1 == 0).all() and (items >= 0).all()
    for g in range(n_groups):  # step 4: each group on its own
        s, e = off[g], off[g + 1]
        vals = [((0 if order_key is None else int(order_key[p])), int(p))
                for p in items[s:e]]
        items[s:e] = [p for _, p in _order(vals, warp_cap)]
    return off, items


@pytest.mark.parametrize("case", sorted(GROUPBY_CASES))
def test_mirror_of_kernels_equals_stable_sort(case):
    key, n_groups, shift = groupby_keys(case, seed=len(case))
    off, items = _mirror(key, n_groups, shift, seed=1)
    want_off, want_items = groupby.group_by_plain(torch.from_numpy(key),
                                                  n_groups, shift)
    np.testing.assert_array_equal(off, want_off.numpy())
    np.testing.assert_array_equal(items, want_items.numpy())
    assert tiers_reached(np.diff(off), groupby.WARP_CAP) == \
        GROUPBY_CASES[case][1]


@pytest.mark.parametrize("case", sorted(GROUPBY_CASES))
def test_group_by_on_cpu_is_its_plain_version(case):
    key, n_groups, shift = groupby_keys(case, seed=2)
    before = groupby.group_by.launches
    off, items = groupby.group_by(torch.from_numpy(key), n_groups, shift)
    assert groupby.group_by.launches == before
    assert off.dtype == items.dtype == torch.int32
    assert off.shape == (n_groups + 1,) and items.shape == (int(off[-1]),)
    group = key.astype(np.int64) >> shift
    want = np.flatnonzero((group >= 0) & (group < n_groups))
    want = want[np.argsort(group[want], kind="stable")]
    np.testing.assert_array_equal(items.numpy(), want)


@pytest.mark.parametrize("virtual", [False, True], ids=["warp", "block"])
@pytest.mark.parametrize("n", [2, 3, 5, 17, 32, 33, 100, 513, 1024, 1500])
def test_bitonic_networks_sort_any_length(n, virtual):
    rng = np.random.default_rng(n)
    vals = [(int(v), i) for i, v in enumerate(rng.integers(0, 7, n))]
    shuffled = [vals[i] for i in rng.permutation(n)]
    assert _bitonic(shuffled, virtual) == sorted(vals)


@pytest.mark.parametrize("n,case", [(3000, "random"), (4096, "hot_key"),
                                    (200, "one_bucket"),
                                    (5000, "one_bucket")])
def test_consensus_buckets_order_as_stable_sort(n, case):
    # B.3's two levels: buckets of high key bits by position, then each
    # bucket by (key, member, position), against the stable sort by
    # (key, member) that aggregate_plain takes.
    from torch_cases import consensus_peaks, consensus_skewed

    key, member = (consensus_peaks(n, seed=n) if case == "random"
                   else consensus_skewed(n, n, case))[:2]
    shift, n_buckets = consensus.bucket_shift(int(key.max()) + 1, n)
    assert n_buckets <= n
    km = (key.astype(np.int64) << 31) | member
    off, items = _mirror(key, n_buckets, shift, seed=3, order_key=km,
                         warp_cap=consensus.WARP_CAP)
    want = torch.sort((torch.from_numpy(key).long() << 32)
                      | torch.from_numpy(member).long(), stable=True)[1]
    np.testing.assert_array_equal(items, want.numpy())
    reached = tiers_reached(np.diff(off), consensus.WARP_CAP)
    if case == "hot_key":
        assert reached == (True, True, True)
    elif case == "one_bucket":
        assert (np.diff(off) > 0).sum() == 1


@pytest.mark.parametrize("big", [False, True],
                         ids=["small_clusters", "big_cluster"])
def test_cluster_rows_of_hashed_medoids(big):
    # B.2's use: key seg (int32), n_groups spill, noise rows in spill (a
    # sink).  After the order step each cluster holds its rows in
    # ascending order and the noise is dropped: what the plain version's
    # stable sort (ops/medoids.py::_segments) gives.
    rng = np.random.default_rng(9)
    n, spill = 4000, 500
    seg = rng.integers(0, spill + 1, n).astype(np.int32)
    seg[rng.random(n) < 0.1] = spill  # more noise
    if big:
        seg[rng.random(n) < 0.4] = 3  # a cluster of ~1,500 rows
    off, items = _mirror(seg, spill, 0, seed=4)
    rows, want_off = medoids._segments(torch.from_numpy(seg), spill)
    np.testing.assert_array_equal(off, want_off.numpy())
    np.testing.assert_array_equal(items, rows[:int(off[-1])].numpy())
    assert (seg[items] != spill).all()
    assert len(items) == int((seg != spill).sum())
    for g in range(spill):
        assert (np.diff(items[off[g]:off[g + 1]]) > 0).all()
    assert tiers_reached(np.diff(off), groupby.WARP_CAP) == (
        True, False, big)


def test_group_by_rejects_bad_inputs():
    key = torch.zeros(10, dtype=torch.int64)
    with pytest.raises(ValueError, match="int32"):
        groupby.group_by(key, 4)
    with pytest.raises(ValueError, match="shift"):
        groupby.group_by(key.int(), 4, shift=32)
    with pytest.raises(ValueError, match="n_groups"):
        groupby.group_by(key.int(), 0)


def _kmeans_fill_mirror(assign, n_lists):
    """csrc/ivf.cu's IVF.2 order in numpy: (list offsets, rows).  The count
    and fill kernels walk each tile alike; the fill writes each row to its
    (list, tile) start from the scanned counts plus its rank."""
    n = len(assign)
    tile = ivf.fill_tile(n_lists)
    n_tiles = -(-n // tile)
    lanes = np.arange(32)

    def walk(t, visit):
        run = np.zeros(n_lists, np.int64)  # the tile's counts in shared
        end = min(t * tile + tile, n)
        for r in range(t * tile, end, 32):  # 32 rows, one per lane
            rows = np.arange(r, min(r + 32, end))
            lists = assign[rows]
            same = lists[:, None] == lists[None, :]
            rank = (same & (lanes[None, :len(rows)]
                            < lanes[:len(rows), None])).sum(1)
            visit(rows, lists, run[lists] + rank)  # each leader's read
            np.add.at(run, lists, 1)  # ... and its group's advance
        return run

    cnt1 = np.zeros(1 + n_lists * n_tiles, np.int64)
    for t in range(n_tiles):
        cnt1[1 + np.arange(n_lists) * n_tiles + t] = walk(
            t, lambda *_: None)
    off = np.cumsum(cnt1)
    items = np.full(n, -1, np.int64)
    for t in range(n_tiles):
        def visit(rows, lists, rank, t=t):
            items[off[lists * n_tiles + t] + rank] = rows
        walk(t, visit)
    return off[np.arange(n_lists + 1) * n_tiles], items


def _kmeans_assign(case):
    rng = np.random.default_rng(len(case))
    if case == "16_lists_many_tiles":
        return rng.integers(0, 16, 5000), 16  # 20 tiles, the last short
    if case == "1024_lists_some_empty":
        a = rng.integers(0, 1024, 131072)
        a[np.isin(a, rng.choice(1024, 40, replace=False))] = 5
        return a, 1024
    if case == "one_list_every_row":
        return np.full(3 * 256 + 17, 3), 16
    # Runs of one list, longer than a tile, beside scattered rows.
    a = rng.integers(0, 64, 9000)
    a[1000:4000] = 63
    return a, 64


KMEANS_FILL_CASES = ["16_lists_many_tiles", "1024_lists_some_empty",
                     "one_list_every_row", "runs_longer_than_a_tile"]


@pytest.mark.parametrize("case", KMEANS_FILL_CASES)
def test_kmeans_fill_mirror_equals_stable_sort(case):
    assign, n_lists = _kmeans_assign(case)
    off, items = _kmeans_fill_mirror(assign, n_lists)
    counts = np.bincount(assign, minlength=n_lists)
    np.testing.assert_array_equal(off, np.concatenate([[0],
                                                       np.cumsum(counts)]))
    np.testing.assert_array_equal(items, np.argsort(assign, kind="stable"))
    assert len(assign) > 2 * ivf.fill_tile(n_lists)  # several tiles
    has_empty = case in ("1024_lists_some_empty", "one_list_every_row")
    assert (counts == 0).any() == has_empty


@pytest.mark.parametrize("n_lists,tile", [(1, 256), (16, 256), (256, 256),
                                          (300, 320), (1024, 1024),
                                          (12288, 2048)])
def test_kmeans_fill_tile(n_lists, tile):
    assert ivf.fill_tile(n_lists) == tile and tile % 32 == 0
