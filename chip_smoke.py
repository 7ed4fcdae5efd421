#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``falcon_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper GPU and
the CUDA toolkit::

    python3 chip_smoke.py [--report PATH] [--root CHECKOUT]

``--root`` runs the same phases on the ``falcon_tpu_torch`` of another
checkout (a parent commit unpacked with ``git archive``), so that runs of
two commits, taken in turns on one card, time the same calls.

It builds the port's CUDA kernels from ``falcon_tpu_torch/csrc`` and then:

1. prints the card (``nvidia-smi``), the torch / CUDA versions and the
   build times of the kernels and of the native host library;
2. holds each kernel against its plain PyTorch version on the same CUDA
   tensors, at the main path's shapes (K4: the bench corpus's intervals
   as the exact engine launches them, and a synthetic set of 2..1,024),
   on tie-heavy cases at round caps 1, 8 and 32, on spectra whose peaks
   are not sorted by m/z and at wide fragment tolerances, and times both
   (each wrapper's call between CUDA events, also at round caps 0 and 1,
   K4's and the pair lists' kernels alone with ``torch.profiler``, a
   synchronised host clock for the plain versions); it counts the edges (peak pairs
   within tolerance) of the timed calls' inputs, from which it computes
   each kernel's bound;
3. runs the port's CLI with its defaults (``--backend exact``) on a
   50,000-spectrum corpus shaped like ``bench.py``'s (hundreds of small
   precursor intervals: the grouped kernel, K4);
4. runs the same CLI on a dense corpus whose precursors crowd into 2 m/z,
   one ~20,000-spectrum interval per charge (the panel kernel, K1);
5. clusters a 3,000-spectrum interval, and with the ann engine's exact
   index a block holding small components and one chain of 1,500 spectra,
   through the kernels and through the plain versions, both on the GPU,
   and requires identical labels and medoids;
6. runs the CLI with ``--backend ann --ann_index exact`` on the
   bench-shaped corpus, the dense corpus and a corpus of long chains of
   similar spectra (large sparse eps-components: the pruned pair lists),
   so the banded kernel (K2) takes every band and the pair-list launcher
   the chains.

Every phase raises on failure, so the script exits non-zero; it also exits
non-zero, printing no result, without a CUDA GPU.  On success the last two
lines of standard output are one JSON object with each kernel's launches,
error, times and bound, then ``{"ok": true, "device": {...}}``.  Neither
JAX nor the JAX package is ever imported.
"""

import argparse
import csv
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

TOL = 0.05            # the CLI's default --fragment_tol
ATOL = 1e-6           # kernel vs plain scores (same summation order)
WIDE_TOLS = (0.5, 2.0)  # fragment tolerances at which columns have many edges
PANEL_ROWS = 2048     # condensed_distances' default row panel
K1_COLS = (4096, 16384)  # K1 parity shapes: PANEL_ROWS x each
K4_SIZES = (2, 3, 5, 8, 13, 31, 64, 100, 137, 257, 513, 1024)
BENCH_CORPUS = dict(n_clusters=3500, cluster_size=10, n_noise=15000,
                    precursor_classes=600, seed=42)
DENSE_CORPUS = dict(n_clusters=3000, cluster_size=10, n_noise=10000,
                    precursor_mz_range=(500.0, 502.0), seed=7)
# Chains of spectra, each a small step from the last (one of 40 peaks
# replaced, precursor 2 ppm higher): eps-components of 1,500 spectra.
CHAIN_CORPUS = dict(n_chains=3, chain_len=1500, seed=11)
ANN = ["--backend", "ann", "--ann_index", "exact"]
K2_BLOCK_ROWS = 4096  # exact_banded_topk's row block
K1, K2, K4, PL = ("K1 panel_scores", "K2 banded_panel_scores",
                  "K4 batched_block_scores", "pair_list_scores")
SOURCES = {K1: "falcon_tpu_torch/csrc/pairwise.cu",
           K2: "falcon_tpu_torch/csrc/exact_knn.cu",
           K4: "falcon_tpu_torch/csrc/pairwise.cu",
           PL: "falcon_tpu_torch/csrc/pairwise.cu"}
# The bound of a kernel's call: the larger of its bytes (each input read
# once, each output written once) over the HBM rate and its operations over
# the float32 rate outside the tensor cores (H100 SXM data sheet, 700 W).
# No PyTorch call computes locally-dominant matching, so no kernel has a
# library yardstick.  The operations are what these inputs need: a merge
# walk over the two m/z-sorted peak lists per pair (a subtraction and a
# compare per step) and, per edge, its product, the > 0 test and the row
# and column maxima; rounds after the first are not counted.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
SEARCH_OPS = 2 * (2 * 64 - 1)
EDGE_OPS = 4
REPLACES = {
    K1: "falcon_tpu/ops/pairwise.py:44",
    K2: "falcon_tpu/ops/exact_knn.py:243",
    K4: "falcon_tpu/ops/pairwise.py:218",
    PL: "falcon_tpu/ops/rerank.py:32",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def preprocess(spectra):
    """Quality-filter and normalise spectra with the CLI's defaults."""
    from falcon_tpu_torch.preprocess import process_spectrum

    rows = [process_spectrum(s, 5, 250, 101.0, 1500.0, 1.5, 0.01, 50, None)
            for s in spectra]
    return [r for r in rows if r is not None]


def padded(rows):
    """(n, 64) float32 m/z and intensity of preprocessed rows."""
    from falcon_tpu_torch.store.store import padded_peaks

    offsets = np.zeros(len(rows) + 1, np.int64)
    offsets[1:] = np.cumsum([len(r["mz"]) for r in rows])
    mz, intensity, _ = padded_peaks(
        offsets, np.concatenate([r["mz"] for r in rows]),
        np.concatenate([r["intensity"] for r in rows]), 64)
    return mz, intensity


def kernel_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` calls, between two CUDA
    events on the stream (host work that the calls wait for included),
    after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_split(fn, reps: int = 5):
    """Device milliseconds per call of each CUDA kernel that ``fn``
    launches, by kernel name (torch.profiler), after one warm-up call;
    empty if the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = getattr(e, "cuda_time_total", 0.0)
        if t > 0:
            out[e.key] = t / 1e3 / reps
    return out


def log_split(name, split):
    if split:
        log(f"  {name} device time by kernel (torch.profiler): " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in sorted(split.items())))
    else:
        log(f"  {name} device time by kernel: not measured (the profiler "
            f"saw no device time)")


def plain_ms(fn):
    """(result, wall milliseconds) of one synchronised call."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


class Parity:
    """Largest kernel-vs-plain score difference per kernel; raises on a
    score beyond ``ATOL`` or any differing match count."""

    def __init__(self):
        self.err = {}

    def check(self, name, what, got, want):
        import torch

        s, m = got
        ws, wm = want
        err = float((s - ws).abs().max()) if s.numel() else 0.0
        self.err[name] = max(self.err.get(name, 0.0), err)
        if err > ATOL:
            raise AssertionError(f"{name} {what}: max |score diff| {err:.3g}"
                                 f" > {ATOL}")
        if (m is None) != (wm is None) or (
                m is not None and not torch.equal(m, wm)):
            raise AssertionError(f"{name} {what}: match counts differ")
        log(f"  {name} {what}: max |score diff| {err:.3g}, match counts "
            f"{'equal' if m is not None else 'not requested'}")


def tie_heavy(n: int, seed: int):
    """Spectra with peaks crowded into a few tolerance windows and
    quantised intensities, each present twice (duplicates tie
    everywhere)."""
    rng = np.random.default_rng(seed)
    mz = np.full((n, 64), -1e6, np.float32)
    intensity = np.zeros((n, 64), np.float32)
    for i in range(n):
        k = int(rng.integers(4, 64))
        centres = rng.choice([200.0, 200.03, 350.0, 500.0], size=k)
        mz[i, :k] = centres + rng.choice([0.0, 0.01, 0.02], size=k)
        intensity[i, :k] = rng.choice([0.25, 0.5], size=k)
    return np.repeat(mz, 2, axis=0), np.repeat(intensity, 2, axis=0)


def chained_spectra(n_chains: int, chain_len: int, seed: int):
    """Chains of spectra in which each member replaces one of the last
    one's 40 peaks and sits 2 ppm higher in precursor m/z: neighbours are
    within eps and tolerance, members far apart are not.  Returns
    (spectra, chain id per spectrum)."""
    from falcon_tpu_torch.ms_io.containers import Spectrum

    rng = np.random.default_rng(seed)
    spectra, truth = [], []
    for c in range(n_chains):
        base = float(rng.uniform(450.0, 1100.0))
        mz = rng.uniform(150.0, 1400.0, 40)
        intensity = rng.uniform(0.5, 1.0, 40)
        for step in range(chain_len):
            spectra.append(Spectrum(
                f"chain{c}_member{step}", base * (1 + 2e-6 * step), 2,
                mz.copy(), intensity.copy(),
                float(rng.uniform(0.0, 3600.0))))
            truth.append(c)
            k = int(rng.integers(40))
            mz[k] = rng.uniform(150.0, 1400.0)
            intensity[k] = rng.uniform(0.5, 1.0)
    return spectra, np.asarray(truth)


def wrappers():
    """The four kernel wrappers, by name: (module, attribute)."""
    from falcon_tpu_torch.ops import exact_knn as ex
    from falcon_tpu_torch.ops import pairwise as pw

    return {K1: (pw, "panel_scores"), K2: (ex, "banded_panel_scores"),
            K4: (pw, "batched_block_scores"), PL: (pw, "pair_list_scores")}


def edge_counts(mz_a, int_a, ii, mz_b, int_b, jj, tol, chunk=1 << 16):
    """Edges of each pair (a[ii[t]], b[jj[t]]): the peak pairs within
    ``tol`` whose intensity product is > 0, the entries the kernels'
    ``match_sorted`` walks.  Plain torch, in chunks of pairs."""
    import torch

    from falcon_tpu_torch.ops.matching import f32_tolerance

    tol = f32_tolerance(tol)
    out = torch.empty(ii.shape[0], dtype=torch.int64, device=ii.device)
    for t0 in range(0, ii.shape[0], chunk):
        a, b = ii[t0:t0 + chunk], jj[t0:t0 + chunk]
        within = (mz_a[a][:, :, None] - mz_b[b][:, None, :]).abs() <= tol
        within &= (int_a[a][:, :, None] * int_b[b][:, None, :]) > 0
        out[t0:t0 + chunk] = within.sum(dim=(1, 2))
    return out


def bound(n_pairs, n_edges, n_bytes):
    """(bound ms, what sets it) of a call; see HBM_BYTES_PER_S."""
    op_ms = (n_pairs * SEARCH_OPS + n_edges * EDGE_OPS) / F32_OPS_PER_S * 1e3
    byte_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    return (op_ms, "operations") if op_ms >= byte_ms else (byte_ms, "bytes")


def log_edges(what, edges):
    log(f"  edges per pair, {what}: mean {float(edges.double().mean()):.3f},"
        f" max {int(edges.max())} ({edges.shape[0]} pairs)")


def permuted(mz, intensity, seed):
    """The same spectra with each one's 64 peaks (padding included) in a
    random order, so no spectrum is sorted by m/z."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    perm = torch.argsort(torch.rand(mz.shape, generator=gen), dim=1)
    perm = perm.to(mz.device)
    return mz.gather(1, perm), intensity.gather(1, perm)


def check_permutation(name, what, got, original):
    """Scores of permuted spectra against those of the originals: the same
    matching, summed over the columns in another order."""
    import torch

    err = float((got[0] - original[0]).abs().max())
    if err > ATOL or not torch.equal(got[1], original[1]):
        raise AssertionError(f"{name} {what}: permuted peaks change the "
                             f"scores by {err:.3g} or the match counts")
    log(f"  {name} {what}: permuted vs original peaks: max |score diff| "
        f"{err:.3g}, match counts equal")


def phase_kernels(dev, dense_rows, bench_rows, bench_all, chain_rows,
                  report):
    """Phase 2: each kernel against its plain version on the card."""
    import torch

    from falcon_tpu_torch.ops import pairwise as pw

    parity = Parity()
    times = {}
    detail = {}

    def cuda(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    mz_all, int_all = padded(dense_rows)
    k1 = K1
    if len(dense_rows) < max(K1_COLS):
        raise RuntimeError(f"the dense interval holds {len(dense_rows)} "
                           f"spectra, fewer than {max(K1_COLS)}")
    for n_cols in K1_COLS:
        # A panel of PANEL_ROWS rows of the sorted interval, starting at a
        # non-zero global row, against the interval's first n_cols rows.
        r0 = n_cols // 4
        mz_c, int_c = cuda(mz_all[:n_cols]), cuda(int_all[:n_cols])
        mz_r, int_r = mz_c[r0:r0 + PANEL_ROWS], int_c[r0:r0 + PANEL_ROWS]
        args = (mz_r, int_r, mz_c, int_c, r0, TOL)
        want, t_plain = plain_ms(lambda: pw.panel_scores_plain(*args))
        upper = (torch.arange(n_cols, device=dev)[None, :]
                 > (r0 + torch.arange(PANEL_ROWS, device=dev))[:, None])
        want_upper = (torch.where(upper, want[0], 0.0),
                      torch.where(upper, want[1], 0))
        shape = f"{PANEL_ROWS}x{n_cols}"
        detail[(k1, shape, "plain")] = t_plain
        log(f"  {k1} {shape}: plain version {t_plain:.1f} ms "
            f"(all pairs, with match counts)")
        for upper_only in (False, True):
            for with_matches in (True, False):
                def run():
                    return pw.panel_scores(*args, upper_only=upper_only,
                                           with_matches=with_matches)
                got = run()
                torch.cuda.synchronize()
                ref = want_upper if upper_only else want
                ref = ref if with_matches else (ref[0], None)
                what = (f"{shape} row_offset={r0} upper_only={upper_only} "
                        f"with_matches={with_matches}")
                parity.check(k1, what, got, ref)
                ms = kernel_ms(run, reps=3)
                detail[(k1, shape, upper_only, with_matches)] = ms
                log(f"  {k1} {what}: kernel {ms:.2f} ms")
        if n_cols == min(K1_COLS):
            # Peaks in no order, and wide tolerances (many edges per
            # column), on the same panel.
            mz_p, int_p = permuted(mz_c, int_c, seed=n_cols)
            p_args = (mz_p[r0:r0 + PANEL_ROWS], int_p[r0:r0 + PANEL_ROWS],
                      mz_p, int_p, r0, TOL)
            got = pw.panel_scores(*p_args)
            parity.check(k1, f"{shape} unsorted peaks", got,
                         pw.panel_scores_plain(*p_args))
            check_permutation(k1, shape, got, want)
            for tol in WIDE_TOLS:
                w_args = (mz_r[:256], int_r[:256], mz_c, int_c, r0, tol)
                parity.check(k1, f"256x{n_cols} fragment_tol={tol}",
                             pw.panel_scores(*w_args),
                             pw.panel_scores_plain(*w_args))
    # The timed call: the full 2048 x 16384 panel with match counts; what
    # its rounds cost, from the time with the round cap at 0 and 1.
    shape = f"{PANEL_ROWS}x{max(K1_COLS)}"
    for rounds in (0, 1):
        detail[(k1, shape, "rounds", rounds)] = kernel_ms(
            lambda: pw.panel_scores(*args, rounds=rounds), reps=3)
    log(f"  {k1} {shape} by round cap: 0 rounds (edges only) "
        f"{detail[(k1, shape, 'rounds', 0)]:.2f} ms, 1 round "
        f"{detail[(k1, shape, 'rounds', 1)]:.2f} ms, 8 rounds "
        f"{detail[(k1, shape, False, True)]:.2f} ms")
    n_rows, n_cols = mz_r.shape[0], mz_c.shape[0]
    ii = torch.arange(n_rows, device=dev).repeat_interleave(n_cols)
    jj = torch.arange(n_cols, device=dev).repeat(n_rows)
    edges = edge_counts(mz_r, int_r, ii, mz_c, int_c, jj, TOL)
    log_edges(f"dense corpus, K1 panel {shape}", edges)
    report["edges"] = {f"K1 dense {shape}": dict(
        mean=float(edges.double().mean()), max=int(edges.max()))}
    times[k1] = dict(
        ms=detail[(k1, shape, False, True)],
        plain_ms=detail[(k1, shape, "plain")],
        **dict(zip(("bound_ms", "bound_by"), bound(
            ii.shape[0], int(edges.sum()),
            (n_rows + n_cols) * 512 + ii.shape[0] * 8))))

    # Tie-heavy spectra (in no m/z order) with the round cap hit, at the
    # CLI's tolerance and at wide ones.
    mz_t, int_t = (cuda(a) for a in tie_heavy(128, seed=5))
    for tol in (TOL,) + WIDE_TOLS:
        for rounds in (1, 8, 32):
            args = (mz_t, int_t, mz_t, int_t, 0, tol, rounds)
            what = f"tie-heavy 256x256 fragment_tol={tol} rounds={rounds}"
            parity.check(k1, what, pw.panel_scores(*args),
                         pw.panel_scores_plain(*args))
    phase_grouped(dev, parity, times, detail, report, bench_all)
    phase_banded(dev, parity, times, detail, report,
                 {"bench": bench_rows, "dense": dense_rows}, chain_rows)
    report["kernel_times_ms"] = {" | ".join(map(str, k)): v
                                 for k, v in detail.items()}
    report["kernel_bounds"] = times
    return parity.err, times


def grouped_launch(rows, dev):
    """K4's launch on the main path: the precursor intervals of 2 to
    ``GROUP_MAX`` spectra of the largest charge of ``rows``, split and
    ordered as the exact engine splits them, in one call.  Returns (m/z,
    intensity, starts) on ``dev``."""
    import torch

    from falcon_tpu_torch.cluster.engine import GROUP_MAX
    from falcon_tpu_torch.cluster.intervals import precursor_mz_splits

    by_charge = {}
    for r in rows:
        by_charge.setdefault(r["precursor_charge"], []).append(r)
    charge_rows = max(by_charge.values(), key=len)
    pmz = np.asarray([r["precursor_mz"] for r in charge_rows], np.float64)
    order = np.argsort(pmz, kind="stable")
    splits = precursor_mz_splits(pmz[order], 20.0, "ppm", 2**15)
    sizes = np.diff(splits)
    keep = [k for k in range(len(sizes)) if 2 <= sizes[k] <= GROUP_MAX]
    picked = [charge_rows[i] for k in keep
              for i in order[splits[k]:splits[k + 1]]]
    mz, intensity = (torch.from_numpy(a).to(dev) for a in padded(picked))
    starts = np.concatenate([[0], np.cumsum(sizes[keep])]).astype(np.int64)
    return mz, intensity, torch.from_numpy(starts).to(dev)


def condensed_pairs(starts):
    """(i, j) of every condensed pair of the intervals ``starts``."""
    import torch

    bounds = starts.tolist()
    iu = [torch.triu_indices(b - a, b - a, 1, device=starts.device) + a
          for a, b in zip(bounds[:-1], bounds[1:]) if b - a >= 2]
    return torch.cat([u[0] for u in iu]), torch.cat([u[1] for u in iu])


def phase_grouped(dev, parity, times, detail, report, bench_rows):
    """Phase 2, continued: K4 at the main path's launch and at a synthetic
    one of 2..1024-spectrum intervals."""
    import torch

    from falcon_tpu_torch.ops import pairwise as pw
    from falcon_tpu_torch.ops.matching import DEFAULT_ROUNDS

    mz_m, int_m, starts_m = grouped_launch(bench_rows, dev)
    # Intervals of 2..1024 consecutive spectra of the sorted bench corpus.
    mz_b, int_b = padded(sorted(bench_rows[:6000],
                                key=lambda r: r["precursor_mz"]))
    starts_s = np.concatenate([[0], np.cumsum(K4_SIZES)]).astype(np.int64)
    mz_s = torch.from_numpy(mz_b[:starts_s[-1]]).to(dev)
    int_s = torch.from_numpy(int_b[:starts_s[-1]]).to(dev)
    shapes = {
        "main": (mz_m, int_m, starts_m),
        "synthetic": (mz_s, int_s, torch.from_numpy(starts_s).to(dev)),
    }
    for name, (mz, intensity, starts) in shapes.items():
        sizes = (starts[1:] - starts[:-1]).tolist()
        n_pairs = sum(m * (m - 1) // 2 for m in sizes)
        shape = (f"{name}: {len(sizes)} intervals of {min(sizes)}.."
                 f"{max(sizes)} spectra, {n_pairs} pairs")
        want, t_plain = plain_ms(lambda: pw.batched_block_scores_plain(
            mz, intensity, starts, TOL))
        for with_matches in (True, False):
            got = pw.batched_block_scores(mz, intensity, starts, TOL,
                                          with_matches=with_matches)
            parity.check(K4, f"{shape} with_matches={with_matches}", got,
                         want if with_matches else (want[0], None))
        # The wrapper's call (input checks with their host syncs, the
        # table of intervals, the sort pre-pass and the pair kernel) by
        # round cap, and the device time of each kernel alone.
        for rounds in (0, 1, DEFAULT_ROUNDS):
            detail[(K4, name, "rounds", rounds)] = kernel_ms(
                lambda: pw.batched_block_scores(mz, intensity, starts, TOL,
                                                rounds, False), reps=5)
        ms = detail[(K4, name, "rounds", DEFAULT_ROUNDS)]
        split = device_split(lambda: pw.batched_block_scores(
            mz, intensity, starts, TOL, with_matches=False))
        detail[(K4, name, "split")] = split
        log_split(f"{K4} {name}", split)
        detail[(K4, name, "plain")] = t_plain
        log(f"  {K4} {shape}: {ms:.3f} ms (round cap 0: "
            f"{detail[(K4, name, 'rounds', 0)]:.3f} ms, 1: "
            f"{detail[(K4, name, 'rounds', 1)]:.3f} ms), plain version "
            f"{t_plain:.1f} ms")
        ii, jj = condensed_pairs(starts)
        edges = edge_counts(mz, intensity, ii, mz, intensity, jj, TOL)
        log_edges(f"bench corpus, K4 {shape}", edges)
        report["edges"][f"K4 {shape}"] = dict(
            mean=float(edges.double().mean()), max=int(edges.max()))
        bound_ms, bound_by = bound(
            n_pairs, int(edges.sum()),
            mz.shape[0] * 512 + 8 * starts.shape[0] + n_pairs * 4)
        detail[(K4, name, "bound")] = (bound_ms, bound_by)
        log(f"  {K4} {name}: bound {bound_ms:.5f} ms ({bound_by}), "
            f"{100 * bound_ms / ms:.2f}% of the call's time")
        if name == "main":
            times[K4] = dict(ms=ms, plain_ms=t_plain, bound_ms=bound_ms,
                             bound_by=bound_by)
            # Peaks in no order on the whole launch, and wide tolerances
            # on its first 60 intervals.
            mz_p, int_p = permuted(mz, intensity, seed=4)
            got = pw.batched_block_scores(mz_p, int_p, starts, TOL)
            parity.check(K4, f"{shape} unsorted peaks", got,
                         pw.batched_block_scores_plain(mz_p, int_p, starts,
                                                       TOL))
            check_permutation(K4, shape, got, want)
            sub = starts[:61]
            n_sub = int(sub[-1])
            for tol in WIDE_TOLS:
                w_args = (mz[:n_sub], intensity[:n_sub], sub, tol)
                parity.check(K4, f"first 60 intervals fragment_tol={tol}",
                             pw.batched_block_scores(*w_args),
                             pw.batched_block_scores_plain(*w_args))

    # Tie-heavy spectra (in no m/z order), with the round cap hit, at the
    # CLI's tolerance and at wide ones; empty and single-spectrum
    # intervals, and rows of more than 32 columns.
    mz_t, int_t = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                   for a in tie_heavy(128, seed=5))
    st = torch.tensor([0, 0, 7, 8, 100, 256], device=dev)
    for tol in (TOL,) + WIDE_TOLS:
        for rounds in (1, 8, 32):
            args = (mz_t, int_t, st, tol, rounds)
            parity.check(K4, f"tie-heavy 5 intervals fragment_tol={tol} "
                         f"rounds={rounds}", pw.batched_block_scores(*args),
                         pw.batched_block_scores_plain(*args))


def band_block(rows, dev):
    """The first row block of ``exact_banded_topk`` on sorted ``rows`` at
    the CLI's 20 ppm: (rows m/z, rows intensity, pool m/z, pool
    intensity, starts, window)."""
    import torch

    from falcon_tpu_torch.ops import exact_knn as ex
    from falcon_tpu_torch.ops.knn import _pow2_at_least

    mz, intensity = padded(rows)
    n = len(rows)
    n_pad = _pow2_at_least(n, 512)
    pool_mz = np.full((n_pad, 64), -1e6, np.float32)
    pool_int = np.zeros((n_pad, 64), np.float32)
    pool_mz[:n], pool_int[:n] = mz, intensity
    starts, window = ex.window_layout(
        np.asarray([r["precursor_mz"] for r in rows]), 20.0, "ppm", n_pad)
    b = min(K2_BLOCK_ROWS, n)
    pool_mz, pool_int = (torch.from_numpy(a).to(dev)
                         for a in (pool_mz, pool_int))
    return (pool_mz[:b], pool_int[:b], pool_mz, pool_int,
            torch.from_numpy(starts[:b]).to(dev), window)


def chain_pair_lists(rows, dev):
    """The pruned linkage's pair lists of one chain, as
    ``pruned_condensed_distances`` builds them on the card: (m/z,
    intensity, ids (m, k))."""
    import torch

    from falcon_tpu_torch.ops import pairwise as pw
    from falcon_tpu_torch.ops.knn import _pow2_at_least
    from falcon_tpu_torch.ops.vectorize import SpectrumHasher
    from falcon_tpu_torch.preprocess import get_dim

    mz, intensity = (torch.from_numpy(a).to(dev) for a in padded(rows))
    _, mz_min, mz_max = get_dim(101.0, 1500.0, TOL)
    hasher = SpectrumHasher(mz_min, mz_max, TOL)
    spread = hasher.vectorize(mz, intensity, norm=False, spread=True)
    plain = hasher.vectorize(mz, intensity, norm=False)
    thr = 1.0 - 0.1 - 1e-3
    kmax = int(pw.ub_pass_counts(spread, plain, thr, 1024).max())
    ids = pw.ub_pass_topk(spread, plain, thr, _pow2_at_least(kmax, 16),
                          1024)
    return mz, intensity, ids


def phase_banded(dev, parity, times, detail, report, rows_by_name,
                 chain_rows):
    """Phase 2, continued: K2 and the pair-list launcher."""
    import torch

    from falcon_tpu_torch.ops import exact_knn as ex
    from falcon_tpu_torch.ops import pairwise as pw

    for name, rows in rows_by_name.items():
        mz_r, int_r, mz_p, int_p, starts, window = band_block(rows, dev)
        args = (mz_r, int_r, mz_p, int_p, starts, 0, window, TOL, 4)
        shape = f"{name} {mz_r.shape[0]}x{window}"
        want, t_plain = plain_ms(lambda: ex.banded_panel_scores_plain(*args))
        detail[(K2, name, "plain")] = t_plain
        for with_matches in (True, False):
            got = ex.banded_panel_scores(*args, with_matches=with_matches)
            torch.cuda.synchronize()
            parity.check(K2, f"{shape} with_matches={with_matches}", got,
                         want if with_matches else (want[0], None))
        # The main path asks for match counts only with min_matches > 0.
        ms = kernel_ms(lambda: ex.banded_panel_scores(
            *args, with_matches=False), reps=5)
        detail[(K2, name, "kernel")] = ms
        log(f"  {K2} {shape}: kernel {ms:.3f} ms, plain version "
            f"{t_plain:.1f} ms ({mz_r.shape[0] * window} pairs)")
        n_rows = mz_r.shape[0]
        ii = torch.arange(n_rows, device=dev).repeat_interleave(window)
        jj = (starts.to(torch.int64)[:, None] * ex.COL_TILE
              + torch.arange(window, device=dev)).reshape(-1)
        edges = edge_counts(mz_r, int_r, ii, mz_p, int_p, jj, TOL)
        log_edges(f"{name} corpus, K2 block {shape}", edges)
        report["edges"][f"K2 {shape}"] = dict(
            mean=float(edges.double().mean()), max=int(edges.max()))
        if name == "dense":
            # The pool columns the block reads, each once.
            n_pool = int(jj.max()) - int(jj.min()) + 1
            times[K2] = dict(ms=ms, plain_ms=t_plain, **dict(zip(
                ("bound_ms", "bound_by"), bound(
                    ii.shape[0], int(edges.sum()),
                    (n_rows + n_pool) * 512 + n_rows * 4
                    + ii.shape[0] * 4))))
            # Peaks in no order, and wide tolerances, on the same block.
            mz_pp, int_pp = permuted(mz_p, int_p, seed=window)
            p_args = (mz_pp[:n_rows], int_pp[:n_rows], mz_pp, int_pp,
                      starts, 0, window, TOL, 4)
            got = ex.banded_panel_scores(*p_args)
            parity.check(K2, f"{shape} unsorted peaks", got,
                         ex.banded_panel_scores_plain(*p_args))
            check_permutation(K2, shape, got, want)
            for tol in WIDE_TOLS:
                w_args = (mz_r[:512], int_r[:512], mz_p, int_p,
                          starts[:512], 0, window, tol, 4)
                parity.check(K2, f"512x{window} fragment_tol={tol}",
                             ex.banded_panel_scores(*w_args),
                             ex.banded_panel_scores_plain(*w_args))

    mz, intensity, ids = chain_pair_lists(chain_rows, dev)
    args = (mz, intensity, mz, intensity, ids, TOL)
    n_pairs = int((ids >= 0).sum())
    shape = (f"chain of {mz.shape[0]}, {ids.shape[1]} slots, "
             f"{n_pairs} pairs")
    want, t_plain = plain_ms(lambda: pw.pair_list_scores_plain(*args, 4))
    for with_matches in (True, False):
        got = pw.pair_list_scores(*args, 4, with_matches=with_matches)
        torch.cuda.synchronize()
        parity.check(PL, f"{shape} with_matches={with_matches}", got,
                     want if with_matches else (want[0], None))
    # The wrapper's call by round cap (the pruned linkage runs 4 rounds; the
    # id check syncs once with the host), and the kernel's device time.
    for rounds in (0, 1, 4):
        detail[(PL, "rounds", rounds)] = kernel_ms(
            lambda: pw.pair_list_scores(*args, rounds, with_matches=False),
            reps=5)
    ms = detail[(PL, "rounds", 4)]
    detail[(PL, "split")] = device_split(
        lambda: pw.pair_list_scores(*args, 4, with_matches=False))
    log_split(PL, detail[(PL, "split")])
    detail[(PL, "plain")] = t_plain
    log(f"  {PL} {shape}: {ms:.4f} ms (round cap 0: "
        f"{detail[(PL, 'rounds', 0)]:.4f} ms, 1: "
        f"{detail[(PL, 'rounds', 1)]:.4f} ms), plain version "
        f"{t_plain:.1f} ms")
    keep = torch.nonzero(ids.reshape(-1) >= 0)[:, 0]
    edges = edge_counts(mz, intensity, keep // ids.shape[1], mz, intensity,
                        ids.reshape(-1)[keep], TOL)
    log_edges(f"chained corpus, pair lists ({shape})", edges)
    report["edges"][f"pair lists {shape}"] = dict(
        mean=float(edges.double().mean()), max=int(edges.max()))
    n_pool = int(torch.unique(ids[ids >= 0]).shape[0])
    times[PL] = dict(ms=ms, plain_ms=t_plain, **dict(zip(
        ("bound_ms", "bound_by"), bound(
            n_pairs, int(edges.sum()),
            (mz.shape[0] + n_pool) * 512 + ids.numel() * 12))))
    # Peaks in no order, and wide tolerances on the first 300 rows.
    mz_p, int_p = permuted(mz, intensity, seed=3)
    p_args = (mz_p, int_p, mz_p, int_p, ids, TOL, 4)
    got = pw.pair_list_scores(*p_args)
    parity.check(PL, f"{shape} unsorted peaks", got,
                 pw.pair_list_scores_plain(*p_args))
    check_permutation(PL, shape, got, want)
    for tol in WIDE_TOLS:
        w_args = (mz[:300], intensity[:300], mz, intensity, ids[:300], tol,
                  4)
        parity.check(PL, f"300x{ids.shape[1]} fragment_tol={tol}",
                     pw.pair_list_scores(*w_args),
                     pw.pair_list_scores_plain(*w_args))

    # Tie-heavy spectra (in no m/z order), with the round cap hit, at the
    # CLI's tolerance and at wide ones; rows with no valid slot and ids
    # repeated within a row.
    mz_t, int_t = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                   for a in tie_heavy(128, seed=6))
    starts = torch.tensor([0, 1] * 64, dtype=torch.int32, device=dev)
    gen = torch.Generator().manual_seed(2)
    ids = torch.randint(0, 256, (128, 40), generator=gen)
    ids[torch.rand(ids.shape, generator=gen) < 0.25] = -1
    ids[::16] = -1
    ids[1::16, 20:] = ids[1::16, :20]
    ids = ids.to(dev)
    for tol in (TOL,) + WIDE_TOLS:
        for rounds in (1, 8, 32):
            args = (mz_t[:128], int_t[:128], mz_t, int_t, starts, 0, 128,
                    tol, rounds)
            parity.check(K2, f"tie-heavy 128x128 fragment_tol={tol} "
                         f"rounds={rounds}",
                         ex.banded_panel_scores(*args),
                         ex.banded_panel_scores_plain(*args))
            args = (mz_t[:128], int_t[:128], mz_t, int_t, ids, tol, rounds)
            parity.check(PL, f"tie-heavy 128x40 fragment_tol={tol} "
                         f"rounds={rounds}", pw.pair_list_scores(*args),
                         pw.pair_list_scores_plain(*args))


def read_labels(csv_path: str):
    """spectrum_id -> cluster label from the CLI's CSV."""
    with open(csv_path, newline="") as f:
        rows = csv.DictReader(line for line in f if not line.startswith("#"))
        return {r["spectrum_id"]: int(r["cluster"]) for r in rows}


def run_cli(name, spectra, truth, tmp, flags=()):
    """Write ``spectra`` as MGF and run the port's CLI on them with its
    defaults and ``flags``; returns (seconds, phase summary, purity,
    completeness, n_clustered)."""
    from falcon_tpu_torch.metrics import cluster_completeness, cluster_purity
    from falcon_tpu_torch.simulate import write_mgf
    from falcon_tpu_torch import cli
    from falcon_tpu_torch.utils.profiling import profiler

    mgf = write_mgf(os.path.join(tmp, f"{name}.mgf"), spectra)
    out = os.path.join(tmp, f"{name}_out")
    t0 = time.perf_counter()
    rc = cli.main([mgf, out, "--work_dir", os.path.join(tmp, f"{name}_work")]
                  + list(flags))
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"{name}: the port's CLI exited {rc}")
    summary = profiler.summary()
    labels = read_labels(out + ".csv")
    truth_by_id = {s.identifier: t for s, t in zip(spectra, truth)}
    # The generator's spectra all pass the quality gates: each one must
    # come back with exactly one label.
    if sorted(labels) != sorted(truth_by_id):
        raise AssertionError(f"{name}: {len(labels)} labelled spectra in "
                             f"the CSV for {len(truth_by_id)} inputs")
    ids = sorted(labels)
    lab = np.array([labels[i] for i in ids])
    tru = np.array([truth_by_id[i] for i in ids])
    return (seconds, summary, cluster_purity(lab, tru),
            cluster_completeness(lab, tru), len(lab))


def largest_interval(rows_by_charge):
    from falcon_tpu_torch.cluster.intervals import precursor_mz_splits

    best = 0
    for rows in rows_by_charge.values():
        mzs = np.sort([r["precursor_mz"] for r in rows])
        best = max(best, int(np.diff(
            precursor_mz_splits(mzs, 20.0, "ppm", 2**15)).max()))
    return best


def phase_main_path(name, spectra, truth, tmp, report, required,
                    flags=(), min_completeness=0.9):
    """Phases 3, 4 and 6: the CLI with ``flags``; returns the launch
    counts of the run and raises if a kernel in ``required`` was never
    launched."""
    kernels = wrappers()
    for module, attr in kernels.values():
        getattr(module, attr).launches = 0
    seconds, summary, purity, completeness, n = run_cli(
        name, spectra, truth, tmp, flags)
    launches = {k: getattr(module, attr).launches
                for k, (module, attr) in kernels.items()}
    log(f"  {n} spectra clustered in {seconds:.2f} s "
        f"({n / seconds:.0f} spectra/s, ingest included)")
    log(f"  launches: {launches}")
    log(f"  purity {purity:.4f}, completeness {completeness:.4f}")
    log("  phases (s): " + ", ".join(f"{k} {v:.3f}"
                                     for k, v in summary.items()))
    report[name] = dict(seconds=seconds, spectra=n,
                        spectra_per_s=n / seconds, purity=purity,
                        completeness=completeness, phases=summary,
                        launches=launches, flags=list(flags))
    for kernel_name in required:
        if launches[kernel_name] <= 0:
            raise AssertionError(f"{name}: {kernel_name} never launched")
    # Both backends recover these generators' clusters almost perfectly
    # (the JAX package: purity 1.00, completeness 0.93 on the bench
    # corpus); far lower values mean wrong distances.
    if purity < 0.99 or completeness < min_completeness:
        raise AssertionError(f"{name}: purity {purity:.4f}, completeness "
                             f"{completeness:.4f} below 0.99 / "
                             f"{min_completeness}")
    return launches


def phase_whole_path(dev, rows, tmp, report):
    """Phase 5: one interval through the kernels and through the plain
    versions, both on the card."""
    from falcon_tpu_torch.store.store import SpectrumStore
    from falcon_tpu_torch.cluster import engine

    store = SpectrumStore(os.path.join(tmp, "whole_path"))
    writer = store.writer()
    writer.add_many(rows)
    writer.close()
    dataset = store.dataset(rows[0]["precursor_charge"])
    args = (dataset, "complete", 0.1, 0, 20.0, "ppm", None, TOL, 2**15)
    compare_kernels_with_plain(
        "whole path, exact backend", report, dev, [K1],
        lambda: engine.generate_clusters(*args, device=dev), len(rows))


def phase_whole_path_ann(dev, rows, tmp, report):
    """Phase 5, continued: the ann engine's exact index on one block,
    through the kernels and through the plain versions, on the card."""
    from falcon_tpu_torch.store.store import SpectrumStore
    from falcon_tpu_torch.cluster import ann_engine

    store = SpectrumStore(os.path.join(tmp, "whole_path_ann"))
    writer = store.writer()
    writer.add_many(rows)
    writer.close()
    dataset = store.dataset(2)
    compare_kernels_with_plain(
        "whole path, ann exact index", report, dev, [K2, K4, PL],
        lambda: ann_engine.generate_clusters(
            dataset, 0.1, 0, 20.0, "ppm", None, TOL, 2**15, device=dev),
        len(rows))


def compare_kernels_with_plain(name, report, dev, required, run, n):
    """Run ``run`` through the kernels, then with every wrapper replaced
    by its plain version; raise unless labels and medoids are identical
    and each kernel in ``required`` was launched."""
    import torch

    kernels = wrappers()
    before = {k: getattr(m, a).launches for k, (m, a) in kernels.items()}
    t0 = time.perf_counter()
    labels, medoids = run()
    t_kernel = time.perf_counter() - t0
    for k in required:
        module, attr = kernels[k]
        if getattr(module, attr).launches == before[k]:
            raise AssertionError(f"{name}: {k} was not launched")
    saved = {k: getattr(m, a) for k, (m, a) in kernels.items()}
    for k, (module, attr) in kernels.items():
        setattr(module, attr, getattr(module, f"{attr}_plain"))
    try:
        t0 = time.perf_counter()
        ref_labels, ref_medoids = run()
        t_plain = time.perf_counter() - t0
    finally:
        for k, (module, attr) in kernels.items():
            setattr(module, attr, saved[k])
    torch.cuda.synchronize()
    same = (np.array_equal(labels, ref_labels)
            and np.array_equal(medoids, ref_medoids))
    log(f"  {name}: {n} spectra, {len(np.unique(labels))} clusters: labels "
        f"and medoids {'identical' if same else 'DIFFER'} (kernels "
        f"{t_kernel:.2f} s, plain versions {t_plain:.2f} s)")
    report[name] = dict(spectra=n, identical=same, kernel_s=t_kernel,
                        plain_s=t_plain)
    if not same:
        raise AssertionError(f"{name}: kernels and plain versions disagree "
                             "on labels or medoids")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--report", help="also write the results as JSON")
    parser.add_argument(
        "--root", help="import falcon_tpu_torch from this checkout instead "
        "of the one beside this script (another commit, timed by the same "
        "phases)")
    args = parser.parse_args()
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU is visible", file=sys.stderr)
        return 1
    import falcon_tpu_torch
    from falcon_tpu_torch import native
    from falcon_tpu_torch.ops import _build
    from falcon_tpu_torch.simulate import make_clustered_spectra

    package = os.path.dirname(os.path.abspath(falcon_tpu_torch.__file__))
    if args.root and os.path.dirname(package) != os.path.abspath(args.root):
        raise RuntimeError(f"falcon_tpu_torch came from {package}, not "
                           f"{args.root}")

    report = {}
    card = card_line()
    log("== phase 1: card, versions, build")
    log(card)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, package "
        f"{os.path.relpath(package)}")
    _build.library()
    log(f"  kernel build: {_build.build_seconds or 0.0:.1f} s "
        f"({os.path.relpath(_build.library_path())})")
    # The native host library too, so that no main path's time holds its
    # build; without it the port would run the SciPy fallback.
    t0 = time.perf_counter()
    if native.get_lib() is None:
        raise RuntimeError("the port's native host library did not build")
    log(f"  native host library: {time.perf_counter() - t0:.1f} s "
        f"({os.path.relpath(native.library_path())})")
    # Registers, shared memory and spills of each kernel (-Xptxas -v).
    report.update(card=card, package=package, torch=torch.__version__,
                  cuda=torch.version.cuda, build_s=_build.build_seconds,
                  build_log=_build.build_log)

    bench_spectra, bench_truth = make_clustered_spectra(**BENCH_CORPUS)
    dense_spectra, dense_truth = make_clustered_spectra(**DENSE_CORPUS)
    dense_by_charge = {}
    for r in preprocess(dense_spectra):
        dense_by_charge.setdefault(r["precursor_charge"], []).append(r)
    charge2 = sorted(dense_by_charge[2], key=lambda r: r["precursor_mz"])
    bench_all = preprocess(bench_spectra)
    bench_rows = sorted(bench_all[:6000], key=lambda r: r["precursor_mz"])
    chain_rows = preprocess(chained_spectra(
        1, CHAIN_CORPUS["chain_len"], seed=3)[0])

    log("== phase 2: kernels against their plain versions on the card")
    dev = torch.device("cuda")
    errs, times = phase_kernels(dev, charge2, bench_rows, bench_all,
                                chain_rows, report)

    launches = []
    with tempfile.TemporaryDirectory(prefix="falcon_chip_smoke_") as tmp:
        log("== phase 3: main path, bench-shaped corpus (small intervals)")
        launches.append(phase_main_path(
            "bench_corpus", bench_spectra, bench_truth, tmp, report, [K4]))
        log("== phase 4: main path, dense corpus (large intervals)")
        big = largest_interval(dense_by_charge)
        log(f"  largest precursor interval: {big} spectra")
        report["dense_largest_interval"] = big
        launches.append(phase_main_path(
            "dense_corpus", dense_spectra, dense_truth, tmp, report, [K1]))
        log("== phase 5: whole path, kernels against plain versions")
        phase_whole_path(dev, charge2[:3000], tmp, report)
        small = [r for r in bench_rows if r["precursor_charge"] == 2][:1500]
        phase_whole_path_ann(dev, small + chain_rows, tmp, report)
        log("== phase 6: main path, --backend ann --ann_index exact")
        log("  bench-shaped corpus")
        launches.append(phase_main_path(
            "ann_bench_corpus", bench_spectra, bench_truth, tmp, report,
            [K2, K4], ANN))
        log("  dense corpus")
        launches.append(phase_main_path(
            "ann_dense_corpus", dense_spectra, dense_truth, tmp, report,
            [K2], ANN))
        log("  chained corpus (eps-components of 1,500 spectra)")
        chains, chain_truth = chained_spectra(**CHAIN_CORPUS)
        # Complete linkage splits a chain into many clusters, so only
        # purity is held to the generator's truth here.
        launches.append(phase_main_path(
            "ann_chained_corpus", chains, chain_truth, tmp, report,
            [K2, PL], ANN, min_completeness=0.0))

    kernels = [
        {"name": k, "route": "cuda", "source": SOURCES[k],
         "replaces": REPLACES[k],
         "launches": sum(run[k] for run in launches),
         "max_abs_err": errs[k], "ms": times[k]["ms"],
         "plain_ms": times[k]["plain_ms"], "bound_ms": times[k]["bound_ms"],
         "bound_by": times[k]["bound_by"], "library_ms": None}
        for k in (K1, K2, K4, PL)
    ]
    report["kernels"] = kernels
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1, default=str)
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
