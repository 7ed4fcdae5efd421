"""Score groups of spectra on the device and link them on the host: the
stage both engines call, for the exact engine's precursor intervals of 2
or more spectra and the ann engine's eps-components."""

import time
from concurrent.futures import ThreadPoolExecutor, as_completed
from typing import Callable, NamedTuple, Optional

import numpy as np

from ..device import worker_stream
from ..ops import pairwise
from ..ops.matching import DEFAULT_ROUNDS
from ..store.store import padded_peaks
from ..utils.profiling import profiler
from .postprocess import link_components


class Linked(NamedTuple):
    """What :func:`score_and_link` returns: each member's label (from 0
    within its group, -1 for a member split off alone); each group's
    cluster count; the groups' medoid ids, group after group (each group's
    noise first), and each group's count of them; the seconds spent
    getting distances and linking."""

    labels: np.ndarray
    n_clusters: np.ndarray
    medoids: np.ndarray
    n_medoids: np.ndarray
    wait_s: float
    link_s: float


def score_and_link(
    offsets: np.ndarray,
    mz_flat: np.ndarray,
    int_flat: np.ndarray,
    pad_to: int,
    rows: np.ndarray,
    group_off: np.ndarray,
    mzs: np.ndarray,
    rts: Optional[np.ndarray],
    linkage: str,
    eps: float,
    precursor_tol_mass: float,
    precursor_tol_mode: str,
    rt_tol: Optional[float],
    min_matches: int,
    fragment_tol: float,
    group_max: int,
    score_large: Callable,
    dev,
    devices=None,
    counters: str = "ann.linkage",
    eps_far: Optional[float] = None,
    rounds: int = DEFAULT_ROUNDS,
) -> Linked:
    """Score and link the groups ``rows[group_off[g]:group_off[g + 1]]``.

    ``rows``: dataset rows of the ragged peaks (``offsets``, ``mz_flat``,
    ``int_flat``), group after group; ``mzs`` and ``rts`` (``rts`` read
    only with ``rt_tol``): each member's precursor m/z and RT.  Groups of
    up to ``group_max`` spectra go in order to K4 launches
    (``pairwise.condensed_distance_groups``) on ``dev``, or round-robin
    over the list ``devices``, each launch padded to ``pad_to`` peaks
    when it is dispatched and linked in one call
    (``postprocess.link_components``; a group closes whole when no
    distance reads above ``eps_far``).  ``score_large(mz, intensity,
    device)`` scores a larger group (padded float32 arrays in, condensed
    float32 distances out), on ``dev`` or on one worker thread a device of
    ``devices``, and the group is linked alone.

    The recorder keeps ``<counters>.components``, ``.pairs``, ``.batches``
    (native calls), ``.whole``, ``.linked`` and the accumulators
    ``.wait_ns`` (getting each launch's or group's distances),
    ``.native_ns`` (the linkage calls) and ``.refine_ns`` (the Python
    around them).
    """
    rows = np.ascontiguousarray(rows, np.int64)
    group_off = np.ascontiguousarray(group_off, np.int64)
    sizes = np.diff(group_off)
    labels = np.full(len(rows), -1, np.int32)
    medoids = np.zeros(len(rows), np.int64)
    n_clusters = np.zeros(len(sizes), np.int64)
    n_medoids = np.zeros(len(sizes), np.int64)
    profiler.count(f"{counters}.components", len(sizes))
    profiler.count(f"{counters}.pairs", int((sizes * (sizes - 1) // 2).sum()))
    spent = {"wait": 0, "link": 0}  # nanoseconds

    def waited(items):
        """``items``, the time spent getting each one counted as waiting."""
        it = iter(items)
        while True:
            t0 = time.perf_counter_ns()
            item = next(it, None)
            dt = time.perf_counter_ns() - t0
            spent["wait"] += dt
            profiler.count(f"{counters}.wait_ns", dt)
            if item is None:
                return
            yield item

    def link(groups, dist):
        """Link, cut, split and pick the medoids of the groups ``groups``,
        whose condensed distances ``dist`` holds in turn."""
        t0 = time.perf_counter_ns()
        n_whole = link_components(
            dist, groups, group_off, mzs, rts, rows, linkage, eps,
            precursor_tol_mass, precursor_tol_mode, rt_tol, labels,
            n_clusters, medoids, n_medoids, eps_far)
        t1 = time.perf_counter_ns()
        profiler.count(f"{counters}.batches")
        profiler.count(f"{counters}.whole", n_whole)
        profiler.count(f"{counters}.linked", len(groups) - n_whole)
        t2 = time.perf_counter_ns()
        spent["link"] += t2 - t0
        profiler.count(f"{counters}.native_ns", t1 - t0)
        profiler.count(f"{counters}.refine_ns", t2 - t1)

    def score(g, d):
        lo, hi = group_off[g], group_off[g + 1]
        mz, intensity, _ = padded_peaks(offsets, mz_flat, int_flat, pad_to,
                                        rows[lo:hi])
        return score_large(mz, intensity, d)

    def on_device(g, d):
        with worker_stream(d):
            return score(g, d)

    small = np.flatnonzero(sizes <= group_max)
    large = np.flatnonzero(sizes > group_max).tolist()
    if len(small):
        small_off = np.zeros(len(small) + 1, np.int64)
        np.cumsum(sizes[small], out=small_off[1:])
        for launch, dist in waited(pairwise.condensed_distance_groups(
                (offsets, mz_flat, int_flat), pad_to,
                rows[np.repeat(sizes <= group_max, sizes)], small_off,
                fragment_tol, min_matches, rounds, device=dev,
                devices=devices)):
            link(small[launch], dist)
    if large and devices:
        with ThreadPoolExecutor(len(devices)) as pool:
            futures = {
                pool.submit(profiler.bind(on_device), g,
                            devices[j % len(devices)]): g
                for j, g in enumerate(large)}
            for future in waited(as_completed(futures)):
                link(np.asarray([futures[future]]), future.result())
    else:
        for g, dist in waited((g, score(g, dev)) for g in large):
            link(np.asarray([g]), dist)

    kept = (np.arange(len(rows)) - np.repeat(group_off[:-1], sizes)
            < np.repeat(n_medoids, sizes))
    return Linked(labels, n_clusters, medoids[kept], n_medoids,
                  spent["wait"] * 1e-9, spent["link"] * 1e-9)
