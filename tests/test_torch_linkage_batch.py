"""The ann engine's batched linkage of eps-components
(``postprocess.link_components``, one native ``fc_link_components`` call a
batch) against the per-component Python composition
(``postprocess.link_component``) that it replaces and that runs where the
native library is unavailable, on seeded batches: equal labels, cluster
counts, medoid ids in their order, and components closed whole, with the
whole test at NumPy's reading of eps or at the cut's."""

import numpy as np
import pytest

from falcon_tpu_torch import native
from falcon_tpu_torch.cluster import postprocess

EPS = 0.1


def _component(rng, m, n_groups, within, spread, tol_mode, rt_spread,
               quantum):
    """Condensed float32 distances of m members in ``n_groups`` latent
    groups (within a group uniform on [0, within), else on [0.3, 1)),
    precursor m/z spread by ``spread`` (ppm or Da) and RTs by
    ``rt_spread``; ``quantum`` rounds distances and m/z to a grid, so
    that they tie."""
    groups = rng.integers(0, n_groups, m)
    ii, jj = np.triu_indices(m, 1)
    same = groups[ii] == groups[jj]
    dist = np.where(same, rng.uniform(0, within, len(ii)),
                    rng.uniform(0.3, 1.0, len(ii)))
    base = rng.uniform(400, 900)
    offs = rng.uniform(0, spread, m)
    mz = base * (1 + offs * 1e-6) if tol_mode == "ppm" else base + offs
    if quantum:
        dist = np.round(dist / quantum) * quantum
        mz = np.round(mz * 1024) / 1024
    rt = rng.uniform(0, rt_spread, m)
    return dist.astype(np.float32), mz, rt


def _batch(seed, sizes, n_groups=3, within=0.15, spread=10.0,
           tol_mode="ppm", rt_spread=0.0, quantum=None):
    rng = np.random.default_rng(seed)
    parts = [_component(rng, m, n_groups, within, spread, tol_mode,
                        rt_spread, quantum) for m in sizes]
    member_off = np.zeros(len(sizes) + 1, np.int64)
    np.cumsum(sizes, out=member_off[1:])
    n = int(member_off[-1])
    return dict(
        dists=[p[0] for p in parts], member_off=member_off,
        mz=np.concatenate([p[1] for p in parts]) if parts else np.zeros(0),
        rt=np.concatenate([p[2] for p in parts]) if parts else np.zeros(0),
        ids=rng.permutation(10 * n + 1)[:n].astype(np.int64))


MIXED = [2, 3, 4, 5, 7, 9, 12, 17, 30, 64, 150, 600]


def _sum_order_batch(seed):
    """Whole components whose float32 row sums round differently in
    another order: distances 1/16 and 2^-28 (under half a unit in the
    last place of 1/16)."""
    batch = _batch(seed, [3, 4, 5, 6, 8] * 60, n_groups=1, within=EPS)
    rng = np.random.default_rng(seed)
    values = np.float32([0.0625, 2.0**-28, 2.0**-27, 0.0])
    batch["dists"] = [values[rng.integers(0, 4, len(d))]
                      for d in batch["dists"]]
    return batch


def _nan_batch(seed):
    """NaN distances in some components: NumPy's maximum is NaN, so they
    close whole, and their medoid is the first NaN row sum."""
    batch = _batch(seed, MIXED * 2)
    rng = np.random.default_rng(seed)
    for d in batch["dists"][::2]:
        d[rng.integers(0, len(d))] = np.nan
    return batch


def _edge_span_batch(seed):
    """Precursor spans a hair over 20 ppm of the lowest m/z, and under 20
    ppm of the highest."""
    batch = _batch(seed, [2, 3, 5, 9, 20, 40], n_groups=1, within=EPS)
    off = batch["member_off"]
    for lo, hi in zip(off[:-1], off[1:]):
        base = batch["mz"][lo]
        batch["mz"][lo:hi] = base * (1 + np.linspace(0, 20.0002e-6, hi - lo))
    return batch

CASES = {
    # (batch, method, tolerance, tolerance mode, rt_tol)
    "sizes_2_to_600": (_batch(1, MIXED), "complete", 20.0, "ppm", None),
    "whole": (_batch(2, [2, 3, 5, 8, 40, 200], n_groups=1, within=EPS),
              "complete", 20.0, "ppm", None),
    "within_eps_span_out": (
        _batch(3, [3, 4, 6, 10, 25, 80], n_groups=1, within=EPS,
               spread=60.0), "complete", 20.0, "ppm", None),
    "ppm_spans_past_20": (_batch(4, MIXED, spread=50.0), "complete", 20.0,
                          "ppm", None),
    "da_spans": (_batch(5, MIXED, spread=0.05, tol_mode="Da"), "complete",
                 0.02, "Da", None),
    "rt_set": (_batch(6, MIXED, spread=30.0, rt_spread=90.0), "complete",
               20.0, "ppm", 30.0),
    "single": (_batch(7, MIXED, spread=30.0), "single", 20.0, "ppm", None),
    "average": (_batch(8, MIXED, spread=30.0), "average", 20.0, "ppm",
                None),
    "distance_and_mz_ties": (
        _batch(9, MIXED, spread=40.0, quantum=1 / 32), "complete", 20.0,
        "ppm", None),
    "ties_single_rt": (
        _batch(10, MIXED, spread=40.0, rt_spread=60.0, quantum=1 / 16),
        "single", 20.0, "ppm", 20.0),
    "da_ties": (_batch(16, MIXED, spread=0.06, tol_mode="Da",
                       quantum=1 / 8), "complete", 0.02, "Da", None),
    "float32_sum_order": (_sum_order_batch(17), "complete", 20.0, "ppm",
                          None),
    "nan_distances": (_nan_batch(18), "complete", 20.0, "ppm", None),
    "spans_at_the_tolerance": (_edge_span_batch(19), "complete", 20.0,
                               "ppm", None),
    "one_large": (_batch(11, [1500], n_groups=6, spread=40.0), "complete",
                  20.0, "ppm", None),
    "empty": (_batch(12, []), "complete", 20.0, "ppm", None),
}


def _run(case, comps, batched, eps=EPS, eps_far=None):
    batch, method, tol, mode, rt_tol = case
    n = len(batch["ids"])
    out = dict(labels=np.full(n, -7, np.int32),
               medoids=np.full(n, -7, np.int64),
               n_clusters=np.full(len(batch["dists"]), -7, np.int64),
               n_medoids=np.full(len(batch["dists"]), -7, np.int64))
    dist = (np.concatenate([batch["dists"][c] for c in comps]) if comps
            else np.zeros(0, np.float32))
    rt = batch["rt"] if rt_tol is not None else None
    if batched:
        out["whole"] = postprocess.link_components(
            dist, np.asarray(comps, np.int64), batch["member_off"],
            batch["mz"], rt, batch["ids"], method, eps, tol, mode, rt_tol,
            out["labels"], out["n_clusters"], out["medoids"],
            out["n_medoids"], eps_far)
        return out
    out["whole"] = 0
    off = batch["member_off"]
    for c in comps:
        lo, hi = off[c], off[c + 1]
        lab, n_cl, med, whole = postprocess.link_component(
            batch["dists"][c], batch["mz"][lo:hi],
            rt[lo:hi] if rt is not None else None, batch["ids"][lo:hi],
            method, eps, tol, mode, rt_tol, eps_far)
        out["labels"][lo:hi] = lab
        out["n_clusters"][c] = n_cl
        out["medoids"][lo:lo + len(med)] = med
        out["n_medoids"][c] = len(med)
        out["whole"] += whole
    return out


def _assert_same(got, want):
    assert got["whole"] == want["whole"]
    for key in ("labels", "n_clusters", "n_medoids", "medoids"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("name", list(CASES))
def test_batch_matches_per_component(name):
    assert native.get_lib() is not None
    case = CASES[name]
    comps = list(range(len(case[0]["dists"])))
    got, want = _run(case, comps, True), _run(case, comps, False)
    _assert_same(got, want)
    k = len(comps)
    if name == "whole":
        assert got["whole"] == k
    if name == "within_eps_span_out":
        assert got["whole"] == 0
    if name in ("sizes_2_to_600", "ppm_spans_past_20", "da_spans", "rt_set",
                "one_large"):
        # Some components were linked, cut into several clusters, and had
        # members split off by the precursor (or RT) test.
        assert got["whole"] < k
        assert (got["n_clusters"] > 1).any()
        assert (got["labels"] == -1).any()


def test_components_out_of_order_leave_the_rest_alone():
    case = CASES["rt_set"]
    comps = [9, 0, 4, 11, 2]
    got, want = _run(case, comps, True), _run(case, comps, False)
    _assert_same(got, want)
    off = case[0]["member_off"]
    untouched = np.ones(len(case[0]["ids"]), bool)
    for c in comps:
        untouched[off[c]:off[c + 1]] = False
    assert (got["labels"][untouched] == -7).all()
    assert (got["n_clusters"][[1, 3, 5]] == -7).all()


@pytest.mark.parametrize("eps_bits", ["float32_eps", "float64_eps"])
def test_distances_equal_to_eps_read_as_numpy_reads_them(eps_bits):
    # A distance equal to float32(eps) is above the float64 eps 0.1; the
    # whole test reads it as NumPy compares a float32 scalar with eps.
    rng = np.random.default_rng(13)
    sizes = [2, 3, 5, 9]
    value = np.float32(EPS) if eps_bits == "float32_eps" else np.float32(
        np.nextafter(np.float32(EPS), np.float32(0)))
    batch = _batch(13, sizes, n_groups=1, within=EPS)
    batch["dists"] = [np.where(rng.random(len(d)) < 0.5, value, d).astype(
        np.float32) for d in batch["dists"]]
    case = (batch, "complete", 20.0, "ppm", None)
    comps = list(range(len(sizes)))
    _assert_same(_run(case, comps, True), _run(case, comps, False))


def test_eps_far_at_eps_reads_distances_as_the_cut_does():
    # float32(0.3) is above the float64 0.3 and is a distance 1 - score can
    # take.  By default such a distance reads as within eps, as NumPy
    # compares it; with eps_far = eps (the exact engine's) it reads as the
    # cut at 0.3 does, above it, and its group is linked, not closed whole.
    eps = 0.3
    value = np.float32(eps)
    assert float(value) > eps
    batch = _batch(20, [2, 3, 5, 9], n_groups=1, within=0.2)
    for d in batch["dists"]:
        d[0] = value
    case = (batch, "complete", 20.0, "ppm", None)
    comps = list(range(4))
    for eps_far, n_whole in ((None, 4), (eps, 0)):
        got = _run(case, comps, True, eps, eps_far)
        _assert_same(got, _run(case, comps, False, eps, eps_far))
        assert got["whole"] == n_whole
    # The pair at float32(0.3) is two clusters of one under the cut: noise.
    flat = native.fcluster(native.linkage(batch["dists"][0], "complete"),
                           eps, n=2)
    assert flat[0] != flat[1]
    assert (got["labels"][:2] == -1).all()


@pytest.mark.parametrize("sizes", [MIXED, [2600]], ids=["mixed", "2600"])
def test_nan_retention_times_split_as_numpy_does(sizes):
    # Python's heap cannot order the NaN RT gaps of cut_1d; the routine
    # pops them in the order heapq does, in small flat clusters and in
    # one of 2600 members.
    batch = _batch(14, sizes, n_groups=1 if len(sizes) == 1 else 3,
                   within=EPS, spread=30.0, rt_spread=90.0)
    rng = np.random.default_rng(14)
    batch["rt"][rng.random(len(batch["rt"])) < 0.1] = np.nan
    case = (batch, "complete", 20.0, "ppm", 30.0)
    comps = list(range(len(sizes)))
    _assert_same(_run(case, comps, True), _run(case, comps, False))


def test_non_finite_distance_in_a_linked_component_raises():
    batch = _batch(15, [6], spread=60.0)
    batch["dists"][0][2] = np.inf
    with pytest.raises(ValueError, match="finite"):
        _run((batch, "complete", 20.0, "ppm", None), [0], True)


def test_without_the_library_each_component_runs_in_python(monkeypatch):
    # SciPy's linkage and cut stand in for the native ones, as they do for
    # native.linkage and native.fcluster.
    case = CASES["sizes_2_to_600"]
    comps = list(range(len(case[0]["dists"])))
    monkeypatch.setattr(native, "get_lib", lambda: None)
    want = _run(case, comps, False)
    calls = []
    link_component = postprocess.link_component

    def spy(*args, **kwargs):
        calls.append(1)
        return link_component(*args, **kwargs)

    monkeypatch.setattr(postprocess, "link_component", spy)
    _assert_same(_run(case, comps, True), want)
    assert len(calls) == len(comps)
