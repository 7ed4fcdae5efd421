"""The fixed-order group-by under the medoid scores (B.1) and the consensus
table (B.3), on the CPU: a mirror of its kernels' steps in numpy against
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
"""

import numpy as np
import pytest
import torch

from falcon_tpu_torch.ops import consensus, groupby
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


def test_group_by_rejects_bad_inputs():
    key = torch.zeros(10, dtype=torch.int64)
    with pytest.raises(ValueError, match="int32"):
        groupby.group_by(key, 4)
    with pytest.raises(ValueError, match="shift"):
        groupby.group_by(key.int(), 4, shift=32)
    with pytest.raises(ValueError, match="n_groups"):
        groupby.group_by(key.int(), 0)
