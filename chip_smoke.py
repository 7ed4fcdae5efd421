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
   the chains;
7. runs the CLI with ``--backend ann`` and its defaults (the upper-bound
   scan over hashed vectors, then the exact rerank) on the same three
   corpora, prints the pair-F1 of its bench-corpus labels against phase
   6's, and runs the bench corpus a second time, which must give the same
   CSV bytes;
8. runs the CLI in dbscan mode (``--cluster_method dbscan``) on the same
   three corpora, under ``--rerank off`` (linkage and dbscan) and with
   consensus representatives on the bench corpus, prints the pair-F1 of
   dbscan mode against ``--backend exact --linkage single`` (recorded, not
   asserted), and runs dbscan mode and the consensus export a second time,
   which must give the same CSV and MGF bytes.

Phase 2 also holds the vectorize kernel (one output, and the fused plain +
spread call) against its plain version at the bench corpus's charge-2 block
(bit for bit, and two launches against each other), times it beside the
``index_add_`` it replaces, times the default path's scan (product and
top-k apart) and rerank (pair-list kernel and sort apart) at that block,
and holds the medoid-score kernels (on that block's lists and unit
vectors) and the consensus kernel (on its consensus input) against their
plain versions bit for bit, timed beside a PyTorch computation of the same
function on ``index_add_``; B.1 and B.3 also on a skewed input each (hub
targets, a hot key), with their device time split by ``torch.profiler``
into the group-by and the walk, which must hold no sort or search
kernel; phase 5 also runs the default index, dbscan mode, ``--rerank
off`` and the consensus spectra through the kernels and through the plain
versions.

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
ANN_DEFAULT = ["--backend", "ann"]
EPS = 0.1  # the CLI's default --eps
K2_BLOCK_ROWS = 4096  # exact_banded_topk's row block
K1, K2, K4, PL, VEC = ("K1 panel_scores", "K2 banded_panel_scores",
                       "K4 batched_block_scores", "pair_list_scores",
                       "vectorize")
B1, B2, B3 = ("B.1 sparse_medoid_scores", "B.2 hashed_medoid_scores",
              "B.3 consensus aggregate")
KERNELS = (K1, K2, K4, PL, VEC, B1, B2, B3)
SOURCES = {K1: "falcon_tpu_torch/csrc/pairwise.cu",
           K2: "falcon_tpu_torch/csrc/exact_knn.cu",
           K4: "falcon_tpu_torch/csrc/pairwise.cu",
           PL: "falcon_tpu_torch/csrc/pairwise.cu",
           VEC: "falcon_tpu_torch/csrc/vectorize.cu",
           B1: "falcon_tpu_torch/csrc/medoids.cu",
           B2: "falcon_tpu_torch/csrc/medoids.cu",
           B3: "falcon_tpu_torch/csrc/consensus.cu"}
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
BF16_OPS_PER_S = 989e12  # dense tensor-core rate, the scan's bf16 product
SEARCH_OPS = 2 * (2 * 64 - 1)
EDGE_OPS = 4
REPLACES = {
    K1: "falcon_tpu/ops/pairwise.py:44",
    K2: "falcon_tpu/ops/exact_knn.py:243",
    K4: "falcon_tpu/ops/pairwise.py:218",
    PL: "falcon_tpu/ops/rerank.py:32",
    VEC: "falcon_tpu/ops/vectorize.py:86",
    B1: "falcon_tpu/cluster/ann_engine.py:180",
    B2: "falcon_tpu/cluster/ann_engine.py:138",
    B3: "falcon_tpu/ops/consensus.py:34",
}
DBSCAN = ANN_DEFAULT + ["--cluster_method", "dbscan"]
RERANK_OFF = ANN_DEFAULT + ["--rerank", "off"]
CONSENSUS = ["--export_representatives", "--representative_method",
             "consensus"]
GROUPBY_FREE = True  # B.1 and B.3 run no sort (set by phase 2)


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
    """The kernels' wrappers, by kernel: [(module, attribute)]; each
    attribute has a plain version named ``<attribute>_plain``."""
    from falcon_tpu_torch.ops import consensus as cs
    from falcon_tpu_torch.ops import exact_knn as ex
    from falcon_tpu_torch.ops import medoids as md
    from falcon_tpu_torch.ops import pairwise as pw
    from falcon_tpu_torch.ops import vectorize as vz

    return {K1: [(pw, "panel_scores")], K2: [(ex, "banded_panel_scores")],
            K4: [(pw, "batched_block_scores")],
            PL: [(pw, "pair_list_scores")],
            VEC: [(vz, "vectorize"), (vz, "vectorize_pair")],
            B1: [(md, "sparse_medoid_scores")],
            B2: [(md, "hashed_medoid_scores")], B3: [(cs, "aggregate")]}


def launch_counts():
    """Launches so far, by kernel."""
    return {k: sum(getattr(m, a).launches for m, a in attrs)
            for k, attrs in wrappers().items()}


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
    phase_default_index(dev, parity, times, detail, report, bench_all)
    phase_dbscan_kernels(dev, parity, times, report, bench_all)
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


def bench_block(bench_all, dev):
    """The bench corpus's charge-2 block as the default ann path holds it:
    (m/z, intensity) padded to the power-of-two row count on ``dev``, and
    the sorted precursor m/z."""
    import torch

    from falcon_tpu_torch.ops.knn import _pow2_at_least

    rows = sorted((r for r in bench_all if r["precursor_charge"] == 2),
                  key=lambda r: r["precursor_mz"])
    n_pad = _pow2_at_least(len(rows), 512)
    mz = np.full((n_pad, 64), -1e6, np.float32)
    intensity = np.zeros((n_pad, 64), np.float32)
    mz[:len(rows)], intensity[:len(rows)] = padded(rows)
    return (torch.from_numpy(mz).to(dev), torch.from_numpy(intensity).to(dev),
            np.asarray([r["precursor_mz"] for r in rows]))


def index_add_inputs(mz, intensity, mapping, min_bound, bin_size, n_bins,
                     dim, spread):
    """(flat output index, weight) of every (shift, spectrum, peak) hit, the
    arguments of the one ``index_add_`` the vectorize kernel replaces."""
    import torch

    from falcon_tpu_torch.ops.vectorize import inverse_bin

    n = mz.shape[0]
    scale = torch.tensor(inverse_bin(bin_size), device=mz.device)
    bins = torch.floor((mz - np.float32(min_bound)) * scale).to(torch.int64)
    base = (torch.arange(n, device=mz.device) * dim)[:, None]
    idx, w = [], []
    for shift in ((-1, 0, 1) if spread else (0,)):
        b = bins + shift
        hit = (b >= 0) & (b < n_bins) & (intensity > 0)
        idx.append((base + mapping[b.clamp(0, n_bins - 1)]).reshape(-1))
        w.append(torch.where(hit, intensity, 0.0).reshape(-1))
    return torch.cat(idx), torch.cat(w)


def phase_default_index(dev, parity, times, detail, report, bench_all):
    """Phase 2, continued: the vectorize kernel, the upper-bound scan (K5:
    a PyTorch product and a stable sort) and the exact rerank (K3: the
    pair-list kernel and a stable sort) at the bench corpus's charge-2
    block, as the default ann path runs them."""
    import torch

    from falcon_tpu_torch.cluster import ann_engine
    from falcon_tpu_torch.ops import knn, rerank
    from falcon_tpu_torch.ops import pairwise as pw
    from falcon_tpu_torch.ops import vectorize as vz
    from falcon_tpu_torch.preprocess import get_dim

    mz, intensity, pmz = bench_block(bench_all, dev)
    n, n_pad = len(pmz), mz.shape[0]
    _, mz_min, mz_max = get_dim(101.0, 1500.0, TOL)
    hasher = vz.SpectrumHasher(mz_min, mz_max, TOL)
    base = (mz, intensity, hasher._mapping(dev), hasher.min_bound,
            hasher.bin_size, hasher.n_bins, hasher.dim_padded)
    mz_p, int_p = permuted(mz, intensity, seed=8)
    err = 0.0
    for spread in (False, True):
        for norm in (False, True):
            args = base + (norm, spread)
            shape = (f"{n} spectra padded to {n_pad}, spread={spread}, "
                     f"norm={norm}")
            got = vz.vectorize(*args)
            again = vz.vectorize(*args)
            want, t_plain = plain_ms(lambda: vz.vectorize_plain(*args))
            p_args = (mz_p, int_p) + args[2:]
            if not (torch.equal(got, want) and torch.equal(got, again)
                    and torch.equal(vz.vectorize(*p_args),
                                    vz.vectorize_plain(*p_args))):
                raise AssertionError(f"{VEC} {shape}: not bit-identical to "
                                     "its plain version or to itself")
            ms = kernel_ms(lambda: vz.vectorize(*args), reps=20)
            idx, w = index_add_inputs(*base[:6], hasher.dim_padded, spread)
            flat = torch.zeros(n_pad * hasher.dim_padded, device=dev)
            library = kernel_ms(lambda: flat.zero_().index_add_(0, idx, w),
                                reps=20)
            if not norm:
                err = max(err, float(
                    (flat.view(n_pad, -1) - got).abs().max()))
            detail[(VEC, spread, norm)] = dict(ms=ms, plain_ms=t_plain,
                                               library_ms=library)
            log(f"  {VEC} {shape}: kernel {ms:.4f} ms, bit-identical to the "
                f"plain version (and on permuted peaks) and across two "
                f"launches; plain version {t_plain:.2f} ms; index_add_ "
                f"{library:.4f} ms")
    parity.err[VEC] = 0.0
    log(f"  {VEC}: index_add_ (atomic) against the kernel, no norm: max "
        f"|diff| {err:.3g}")
    # Bytes: the peaks and the table read once, the vectors written once;
    # the operations (a bin and a compare per peak and shift, a product
    # and a sum per dimension) are far below them.
    n_bytes = (n_pad * 64 * 8 + hasher.n_bins * 8
               + n_pad * hasher.dim_padded * 4)
    n_ops = n_pad * (3 * 64 * 6 + hasher.dim_padded * 3)
    vec_bound = max((n_bytes / HBM_BYTES_PER_S * 1e3, "bytes"),
                    (n_ops / F32_OPS_PER_S * 1e3, "operations"))
    main = detail[(VEC, True, False)]  # the scan's queries
    times[VEC] = dict(ms=main["ms"], plain_ms=main["plain_ms"],
                      library_ms=main["library_ms"], bound_ms=vec_bound[0],
                      bound_by=vec_bound[1])
    log(f"  {VEC}: bound {vec_bound[0]:.5f} ms ({vec_bound[1]}, "
        f"{n_bytes / 1e6:.1f} MB), {100 * vec_bound[0] / main['ms']:.1f}% "
        f"of the spread call's time")
    # The fused call of the default path: plain and spread from one read.
    got = vz.vectorize_pair(*base)
    again = vz.vectorize_pair(*base)
    want, t_plain = plain_ms(lambda: vz.vectorize_pair_plain(*base))
    p_args = (mz_p, int_p) + base[2:]
    singles = (vz.vectorize(*base, False, False),
               vz.vectorize(*base, False, True))
    same = all(torch.equal(g, a) and torch.equal(g, w) and torch.equal(g, o)
               for g, a, w, o in zip(got, again, want, singles))
    same &= all(torch.equal(g, w) for g, w in zip(
        vz.vectorize_pair(*p_args), vz.vectorize_pair_plain(*p_args)))
    if not same:
        raise AssertionError(f"{VEC} fused plain + spread: not bit-identical "
                             "to its plain version, to itself or to the "
                             "single calls")
    pair_ms = kernel_ms(lambda: vz.vectorize_pair(*base), reps=20)
    for what, fn in (("spread", lambda: vz.vectorize(*base, False, True)),
                     ("fused", lambda: vz.vectorize_pair(*base))):
        detail[(VEC, what, "split")] = device_split(fn, reps=20)
        log_split(f"{VEC} {what}", detail[(VEC, what, "split")])
    pair_bytes = n_bytes + n_pad * hasher.dim_padded * 4
    pair_bound = pair_bytes / HBM_BYTES_PER_S * 1e3
    pair_library = (detail[(VEC, False, False)]["library_ms"]
                    + detail[(VEC, True, False)]["library_ms"])
    report["vectorize_pair"] = dict(ms=pair_ms, plain_ms=t_plain,
                                    library_ms=pair_library,
                                    bound_ms=pair_bound, bound_by="bytes")
    log(f"  {VEC} fused plain + spread ({n} spectra padded to {n_pad}): "
        f"kernel {pair_ms:.4f} ms, bit-identical to the plain version (and "
        f"on permuted peaks), across two launches and to the two single "
        f"calls; plain version {t_plain:.2f} ms; two index_add_ "
        f"{pair_library:.4f} ms; bound {pair_bound:.5f} ms (bytes, "
        f"{pair_bytes / 1e6:.1f} MB), {100 * pair_bound / pair_ms:.1f}% of "
        f"its time")

    # K5: the scan as the engine runs it (its width widened for the
    # bench corpus's bands), whole, then its products and its top-k alone.
    plain = vz.vectorize(*base, False, False)
    spread = vz.vectorize(*base, False, True)
    k_scan = ann_engine.scan_width(pmz, 20.0, "ppm", 64, 128)

    def scan():
        return knn.knn_banded(plain, pmz, 20.0, "ppm", k_scan,
                              q_vectors=spread, scan_bf16=True)

    sims, neigh = scan()
    scan_ms = kernel_ms(scan, reps=3)
    starts, block_rows, window, _ = knn.block_geometry(
        *knn.band_bounds(pmz, 20.0, False), n, 1024)
    n_blocks = -(-n // block_rows)
    q16, c16 = spread.bfloat16().float(), plain.bfloat16().float()

    def products():
        for b in range(n_blocks):
            q16[b * block_rows:(b + 1) * block_rows] @ c16[
                int(starts[b]):int(starts[b]) + window].t()

    product_ms = kernel_ms(products, reps=3)
    tile = torch.rand((block_rows, window), device=dev)

    def sorts():
        for _ in range(n_blocks):
            knn.stable_topk(tile, k_scan)

    sort_ms = kernel_ms(sorts, reps=3)
    split = device_split(scan, reps=2)
    device_ms = sum(split.values())
    top = sorted(split.items(), key=lambda kv: -kv[1])[:8]
    log(f"  K5 scan device time by kernel (torch.profiler), "
        f"{device_ms:.3f} ms in all: " + "; ".join(
            f"{k[:70]} {v:.3f} ms" for k, v in top))
    flops = 2.0 * n_blocks * block_rows * window * hasher.dim_padded
    scan_bytes = 2 * n_pad * hasher.dim_padded * 4 + n_pad * k_scan * 12
    scan_bound = max((flops / BF16_OPS_PER_S * 1e3, "operations"),
                     (scan_bytes / HBM_BYTES_PER_S * 1e3, "bytes"))
    report["K5 scan"] = dict(
        ms=scan_ms, product_ms=product_ms, sort_ms=sort_ms,
        device_ms=device_ms, device_split=split, k=k_scan,
        blocks=n_blocks, block_rows=block_rows, window=window, gflop=flops
        / 1e9, bound_ms=scan_bound[0], bound_by=scan_bound[1],
        f32_route_bound_ms=flops / F32_OPS_PER_S * 1e3)
    log(f"  K5 scan (PyTorch: product + stable sort), k={k_scan}, "
        f"{n_blocks} blocks of {block_rows}x{window}: {scan_ms:.3f} ms; "
        f"products alone (float32 of bf16-rounded operands, TF32 off) "
        f"{product_ms:.3f} ms, top-k sorts alone {sort_ms:.3f} ms; "
        f"{flops / 1e9:.1f} GFLOP, bound {scan_bound[0]:.4f} ms "
        f"({scan_bound[1]}; the products take "
        f"{flops / BF16_OPS_PER_S * 1e3:.4f} ms at the bf16 rate, "
        f"{flops / F32_OPS_PER_S * 1e3:.3f} ms at the float32 rate)")

    # K3: compaction as the engine does it, then the rerank.
    ids = ann_engine.compact_candidates(sims, neigh, EPS)
    k_compact = ids.shape[1]
    got = rerank.rerank_exact(mz, intensity, ids, TOL, 64)
    want = rerank.rerank_scan_body(mz, intensity, mz, intensity, ids, TOL,
                                   64)
    torch.cuda.synchronize()
    n_pairs = int((ids >= 0).sum())
    shape = f"{n_pad}x{k_compact} lists, {n_pairs} pairs"
    parity.check(PL, f"rerank {shape}", (got[0], got[2]), (want[0], want[2]))
    if not torch.equal(got[1], want[1]):
        raise AssertionError(f"rerank {shape}: ids differ from the plain "
                             "version's")
    rerank_ms = kernel_ms(lambda: rerank.rerank_exact(
        mz, intensity, ids, TOL, 64), reps=5)
    scores, _ = pw.pair_list_scores(mz, intensity, mz, intensity, ids, TOL, 4)
    pl_ms = kernel_ms(lambda: pw.pair_list_scores(
        mz, intensity, mz, intensity, ids, TOL, 4), reps=5)
    topk_ms = kernel_ms(lambda: knn.stable_topk(scores, min(64, k_compact)),
                        reps=5)
    # Bound: the pair lists' (queries and listed pool rows read once, ids
    # read, the kept scores, ids and counts written) and their edges.
    keep = torch.nonzero(ids.reshape(-1) >= 0)[:, 0]
    edges = edge_counts(mz, intensity, keep // k_compact, mz, intensity,
                        ids.reshape(-1)[keep], TOL)
    log_edges(f"bench corpus, rerank ({shape})", edges)
    k_out = min(64, k_compact)
    rerank_bound = bound(
        n_pairs, int(edges.sum()),
        (n_pad + int(torch.unique(ids[ids >= 0]).shape[0])) * 512
        + ids.numel() * 8 + n_pad * k_out * 16)
    report["K3 rerank"] = dict(ms=rerank_ms, pair_lists_ms=pl_ms,
                               sort_ms=topk_ms, pairs=n_pairs,
                               k_compact=k_compact,
                               edges_per_pair=float(edges.double().mean()),
                               bound_ms=rerank_bound[0],
                               bound_by=rerank_bound[1])
    log(f"  K3 rerank (pair-list kernel + stable sort), {shape}: "
        f"{rerank_ms:.3f} ms; pair lists with counts {pl_ms:.3f} ms, top-k "
        f"sort {topk_ms:.3f} ms; bound {rerank_bound[0]:.5f} ms "
        f"({rerank_bound[1]})")


def sparse_medoid_library(sims, neigh, seg, spill):
    """The sparse medoid scores as PyTorch computes them with index_add_
    (the JAX body's masks, then the two scatter-adds); atomic on CUDA."""
    import torch

    n_pad, k = sims.shape
    rows = torch.arange(n_pad, device=sims.device)
    safe = neigh.clamp(0, n_pad - 1)
    seg = seg.long()
    valid = (neigh >= 0) & (seg[:, None] != spill) & (seg[safe]
                                                      == seg[:, None])
    mutual = (neigh[safe] == rows[:, None, None]).any(-1)
    counted = valid & ((rows[:, None] < safe) | ~mutual)
    w = torch.where(counted, sims.clamp_min(0.0), 0.0)
    out = torch.zeros(n_pad + 1, device=sims.device)
    out.index_add_(0, rows, w.sum(1))
    out.index_add_(0, torch.where(counted, safe, n_pad).reshape(-1),
                   w.reshape(-1))
    return out[:n_pad]


def hashed_medoid_library(vectors, seg, spill):
    """The hashed medoid scores with index_add_ and a row dot."""
    import torch

    seg = seg.long()
    v = vectors[:seg.shape[0]]
    sums = torch.zeros((spill + 1, v.shape[1]), device=v.device)
    sums.index_add_(0, seg, v)
    return (v * sums[seg]).sum(1)


def aggregate_library(key, member, mz, intensity):
    """The consensus table with the same sort, then index_add_ and
    scatter_reduce_ per key."""
    import torch

    order = torch.sort((key.long() << 32) | member.long(), stable=True)[1]
    key, member, mz, intensity = (a[order] for a in (key, member, mz,
                                                     intensity))
    first = torch.ones_like(key, dtype=torch.bool)
    first[1:] = key[1:] != key[:-1]
    new_member = first.clone()
    new_member[1:] |= member[1:] != member[:-1]
    seg = torch.cumsum(first.long(), 0) - 1
    n_keys = int(seg[-1]) + 1
    int_sum = torch.zeros(n_keys, device=key.device).index_add_(
        0, seg, intensity)
    mzint_sum = torch.zeros(n_keys, device=key.device).index_add_(
        0, seg, mz * intensity)
    members = torch.zeros(n_keys, dtype=torch.int32,
                          device=key.device).index_add_(
        0, seg, new_member.int())
    keys = torch.zeros(n_keys, dtype=torch.int32,
                       device=key.device).scatter_reduce_(
        0, seg, key, "amax", include_self=False)
    return keys, int_sum, mzint_sum, members


def check_bits(name, what, got, again, want):
    """Raise unless a kernel's result equals its plain version's and its
    own second launch's, bit for bit (tuples compared element-wise)."""
    import torch

    got, again, want = (x if isinstance(x, tuple) else (x,)
                        for x in (got, again, want))
    if not all(torch.equal(g, a) and torch.equal(g, w)
               for g, a, w in zip(got, again, want)):
        raise AssertionError(f"{name} {what}: not bit-identical to its plain "
                             "version or to its own second launch")


def groupby_split(name, fn, walk, other):
    """Device milliseconds per call of a B.1 / B.3 wrapper (torch.profiler),
    summed into the walk (the kernels named in ``walk``, with the short
    groups' order fused in), ``other`` kernels, and the group-by (all the
    rest: zeroing, counts, scans, fill, the long groups' order); raises if
    a sort or a search ran."""
    split = device_split(fn, reps=10)
    log_split(name, split)
    if not split:
        return {}
    banned = [k for k in split if "sort" in k.lower() or "search" in k.lower()]
    if banned and not GROUPBY_FREE:  # an older package (--root)
        log(f"  {name}: sort or search kernels ran (older package)")
    elif banned:
        raise AssertionError(f"{name}: sort or search kernels ran: {banned}")
    walk_ms = sum(v for k, v in split.items() if any(w in k for w in walk))
    other_ms = sum(v for k, v in split.items() if any(w in k for w in other))
    total = sum(split.values())
    out = dict(device_ms=total, groupby_ms=total - walk_ms - other_ms,
               walk_ms=walk_ms, other_ms=other_ms, kernels=split)
    log(f"  {name} device time: {total:.4f} ms = group-by "
        f"{out['groupby_ms']:.4f} + walk {walk_ms:.4f} + {'/'.join(other)} "
        f"{other_ms:.4f} ms"
        + ("" if banned else "; no sort or search kernel ran"))
    return out


def skewed_medoids(dev, args, n):
    """B.1 at the block's shape with hubs: the first 3,000 rows made one
    cluster whose rows list row 0 in slot 0 (an in-degree of ~3,000, a
    block's sort) and rows 6..305 rows 1..5 in slot 1 (60 each, a warp's);
    bit for bit against the plain version and across two launches, timed."""
    import torch

    from falcon_tpu_torch.ops import medoids as md

    sims, neigh, seg = (a.clone() for a in args[:3])
    m = min(3000, n)
    seg[:m] = 0
    neigh[1:m, 0] = 0
    sims[1:m, 0] = 0.5
    neigh[6:306, 1] = 1 + torch.arange(300, device=dev) % 5
    sims[6:306, 1] = 0.75
    skewed = (sims, neigh, seg, args[3])
    got = md.sparse_medoid_scores(*skewed)
    again = md.sparse_medoid_scores(*skewed)
    in_degree = torch.bincount(neigh[neigh >= 0], minlength=neigh.shape[0])
    shape = (f"hubs, listed in-degree max {int(in_degree.max())}, "
             f"{int(((in_degree > 16) & (in_degree <= 1024)).sum())} targets "
             f"of 17..1,024")
    check_bits(B1, shape, got, again, md.sparse_medoid_scores_plain(*skewed))
    ms = kernel_ms(lambda: md.sparse_medoid_scores(*skewed), reps=10)
    log(f"  {B1} {shape}: wrapper {ms:.4f} ms, bit-identical to the plain "
        f"version and across two launches")
    return dict(ms=ms, max_in_degree=int(in_degree.max()))


def skewed_consensus(inputs, kw):
    """B.3 on the block's consensus input with every other one of its
    first 40,000 peaks moved into the first peak's key (a bucket of over
    20,000 peaks, ordered in global memory); bit for bit against the plain
    version and across two launches, timed; and the group-by alone on its
    buckets against its plain version."""
    import torch

    from falcon_tpu_torch.ops import consensus as cs
    from falcon_tpu_torch.ops import groupby

    key = inputs[0].clone()
    key[:40000:2] = key[0]
    skewed = (key,) + tuple(inputs[1:])
    got, again = cs.aggregate(*skewed, **kw), cs.aggregate(*skewed, **kw)
    shift, n_buckets = cs.bucket_shift(kw["max_key"], key.shape[0])
    sizes = torch.bincount((key >> shift).long(), minlength=n_buckets)
    shape = (f"{key.shape[0]} peaks, a key of "
             f"{int((key == key[0]).sum())}, largest bucket {int(sizes.max())}")
    check_bits(B3, shape, got, again, cs.aggregate_plain(*skewed))
    ms = kernel_ms(lambda: cs.aggregate(*skewed, **kw), reps=5)
    for a, b in zip(groupby.group_by(key, n_buckets, shift),
                    groupby.group_by_plain(key, n_buckets, shift)):
        if not torch.equal(a, b):
            raise AssertionError(f"group_by {shape}: differs from the "
                                 "stable sort")
    log(f"  {B3} {shape}: wrapper {ms:.4f} ms, bit-identical to the plain "
        f"version and across two launches; group_by alone equals the "
        f"stable sort")
    return dict(ms=ms, largest_bucket=int(sizes.max()))


def phase_dbscan_kernels(dev, parity, times, report, bench_all):
    """Phase 2, continued: the medoid-score kernels on the bench corpus's
    charge-2 block as dbscan mode holds it (B.1 on the default path's
    exact lists, B.2 on its unit vectors), and the consensus kernel (B.3)
    on that block's consensus input; each bit for bit against its plain
    version and its own second launch, timed beside PyTorch's index_add_
    computation of the same function."""
    import torch

    from falcon_tpu_torch.cluster import ann_engine
    from falcon_tpu_torch.ops import consensus as cs
    from falcon_tpu_torch.ops import medoids as md
    from falcon_tpu_torch.ops import vectorize as vz
    from falcon_tpu_torch.ops.density import dbscan
    from falcon_tpu_torch.preprocess import get_dim

    global GROUPBY_FREE
    # Packages before the group-by (a parent through --root) sort: their
    # B.1 and B.3 are timed, but neither checked for sorts nor skewed.
    GROUPBY_FREE = hasattr(cs, "bucket_shift")
    mz, intensity, pmz = bench_block(bench_all, dev)
    n, n_pad = len(pmz), mz.shape[0]
    _, mz_min, mz_max = get_dim(101.0, 1500.0, TOL)
    hasher = vz.SpectrumHasher(mz_min, mz_max, TOL)
    sims, neigh = ann_engine._prefilter_rerank(
        mz, intensity, pmz, np.zeros(n), hasher, EPS, 0, 20.0, "ppm", None,
        TOL, 64, 128, dev)
    sims, neigh = sims.contiguous(), neigh.contiguous()
    labels = dbscan(sims, neigh, EPS, n, 2)
    spill = int(labels.max()) + 1
    seg = np.where(labels >= 0, labels, spill).astype(np.int32)
    seg_pad = np.full(n_pad, spill, np.int32)
    seg_pad[:n] = seg
    read = torch.from_numpy(seg != spill).to(dev)

    # B.1 on the exact lists, then with two hubs at the same shape.
    args = (sims, neigh, torch.from_numpy(seg_pad).to(dev), spill)
    got, again = md.sparse_medoid_scores(*args), md.sparse_medoid_scores(*args)
    want, t_plain = plain_ms(lambda: md.sparse_medoid_scores_plain(*args))
    shape = (f"{n_pad}x{sims.shape[1]} lists, "
             f"{int((neigh[:n] >= 0).sum())} listed pairs, {spill} clusters")
    check_bits(B1, shape, got, again, want)
    ms = kernel_ms(lambda: md.sparse_medoid_scores(*args), reps=10)
    library = kernel_ms(lambda: sparse_medoid_library(*args), reps=3)
    lib_err = float((sparse_medoid_library(*args)[:n] - got[:n])[read]
                    .abs().max())
    n_bytes = sims.numel() * 12 + n_pad * 8
    split = groupby_split(B1, lambda: md.sparse_medoid_scores(*args),
                          ("medoid_sums",), ("medoid_weights",))
    times[B1] = dict(ms=ms, plain_ms=t_plain, library_ms=library,
                     bound_ms=n_bytes / HBM_BYTES_PER_S * 1e3,
                     bound_by="bytes")
    report[f"{B1} split"] = split
    parity.err[B1] = 0.0
    log(f"  {B1} {shape}: wrapper {ms:.4f} ms (weights, group-by, sums), "
        f"bit-identical to the plain version and across two launches; "
        f"plain version {t_plain:.1f} ms; index_add_ version {library:.4f} "
        f"ms (max |diff| {lib_err:.3g} on the rows read); bound "
        f"{times[B1]['bound_ms']:.5f} ms (bytes)")
    if GROUPBY_FREE:
        report["B.1 skewed"] = skewed_medoids(dev, args, n)

    # B.2 on the unit vectors of --rerank off.
    unit = vz.normalize_rows(hasher.vectorize(mz, intensity, norm=False))
    seg_n = torch.from_numpy(seg).to(dev)
    args = (unit, seg_n, spill)
    got, again = md.hashed_medoid_scores(*args), md.hashed_medoid_scores(*args)
    want, t_plain = plain_ms(lambda: md.hashed_medoid_scores_plain(*args))
    shape = f"{n} rows x {unit.shape[1]}, {spill} clusters"
    check_bits(B2, shape, got, again, want)
    ms = kernel_ms(lambda: md.hashed_medoid_scores(*args), reps=10)
    library = kernel_ms(lambda: hashed_medoid_library(*args), reps=10)
    lib_err = float((hashed_medoid_library(*args) - got)[read].abs().max())
    n_bytes = n * unit.shape[1] * 4 + n * 8
    times[B2] = dict(ms=ms, plain_ms=t_plain, library_ms=library,
                     bound_ms=n_bytes / HBM_BYTES_PER_S * 1e3,
                     bound_by="bytes")
    parity.err[B2] = 0.0
    log(f"  {B2} {shape}: kernel {ms:.4f} ms, bit-identical to the plain "
        f"version and across two launches; plain version {t_plain:.1f} ms; "
        f"index_add_ + row dot {library:.4f} ms (max |diff| {lib_err:.3g} "
        f"on the rows read); bound {times[B2]['bound_ms']:.5f} ms (bytes)")

    # B.3 on the consensus input of the block's clusters (noise as
    # singletons), as consensus_spectra hands it to aggregate.
    promoted = labels.copy()
    noise = promoted < 0
    promoted[noise] = spill + np.arange(int(noise.sum()))
    mz_h, int_h = mz[:n].cpu().numpy(), intensity[:n].cpu().numpy()
    keep = int_h > 0
    offsets = np.concatenate([[0], np.cumsum(keep.sum(1))]).astype(np.int64)
    captured = []
    aggregate = cs.aggregate

    def capture(*inputs, **kw):
        captured.append((inputs, kw))
        return cs.aggregate_plain(*inputs)

    cs.aggregate = capture
    try:
        cs.consensus_spectra(offsets, mz_h[keep], int_h[keep], promoted, TOL,
                             mz_min, device=dev)
    finally:
        cs.aggregate = aggregate
    inputs, kw = captured[0]
    got, again = cs.aggregate(*inputs, **kw), cs.aggregate(*inputs, **kw)
    want, t_plain = plain_ms(lambda: cs.aggregate_plain(*inputs))
    shape = f"{inputs[0].shape[0]} peaks, {got[0].shape[0]} keys"
    check_bits(B3, shape, got, again, want)
    ms = kernel_ms(lambda: cs.aggregate(*inputs, **kw), reps=10)
    library = kernel_ms(lambda: aggregate_library(*inputs), reps=10)
    lib_err = float((aggregate_library(*inputs)[2] - got[2]).abs().max())
    n_bytes = inputs[0].shape[0] * 16 + got[0].shape[0] * 16
    split = groupby_split(B3, lambda: cs.aggregate(*inputs, **kw),
                          ("consensus_walk",), ("consensus_compact",))
    times[B3] = dict(ms=ms, plain_ms=t_plain, library_ms=library,
                     bound_ms=n_bytes / HBM_BYTES_PER_S * 1e3,
                     bound_by="bytes")
    report[f"{B3} split"] = split
    parity.err[B3] = 0.0
    log(f"  {B3} {shape}: wrapper {ms:.4f} ms, "
        f"bit-identical to the plain version and across two launches; plain "
        f"version {t_plain:.1f} ms; sort + index_add_ / scatter_reduce_ "
        f"{library:.4f} ms (max |m/z sum diff| {lib_err:.3g}); bound "
        f"{times[B3]['bound_ms']:.5f} ms (bytes)")
    if GROUPBY_FREE:
        report["B.3 skewed"] = skewed_consensus(inputs, kw)


def read_labels(csv_path: str):
    """spectrum_id -> cluster label from the CLI's CSV."""
    with open(csv_path, newline="") as f:
        rows = csv.DictReader(line for line in f if not line.startswith("#"))
        return {r["spectrum_id"]: int(r["cluster"]) for r in rows}


def run_cli(name, spectra, truth, tmp, flags=()):
    """Write ``spectra`` as MGF and run the port's CLI on them with its
    defaults and ``flags``; returns (seconds, phase summary, purity,
    completeness, labels by spectrum id)."""
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
            cluster_completeness(lab, tru), labels)


def largest_interval(rows_by_charge):
    from falcon_tpu_torch.cluster.intervals import precursor_mz_splits

    best = 0
    for rows in rows_by_charge.values():
        mzs = np.sort([r["precursor_mz"] for r in rows])
        best = max(best, int(np.diff(
            precursor_mz_splits(mzs, 20.0, "ppm", 2**15)).max()))
    return best


def phase_main_path(name, spectra, truth, tmp, report, required,
                    flags=(), min_completeness=0.9, min_purity=0.99):
    """Phases 3, 4, 6, 7 and 8: the CLI with ``flags``; returns the launch
    counts of the run and raises if a kernel in ``required`` was never
    launched.  The run's labels by spectrum id go to
    ``report["labels"][name]`` (left out of the JSON report)."""
    for attrs in wrappers().values():
        for module, attr in attrs:
            getattr(module, attr).launches = 0
    seconds, summary, purity, completeness, labels = run_cli(
        name, spectra, truth, tmp, flags)
    n = len(labels)
    report.setdefault("labels", {})[name] = labels
    launches = launch_counts()
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
    if purity < min_purity or completeness < min_completeness:
        raise AssertionError(f"{name}: purity {purity:.4f}, completeness "
                             f"{completeness:.4f} below {min_purity} / "
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
            dataset, 0.1, 2, 0, 20.0, "ppm", None, TOL, 2**15,
            ann_index="exact", device=dev),
        len(rows))


def phase_whole_path_default(dev, rows, tmp, report):
    """Phase 5, continued: the default ann index (vectors, bound scan,
    rerank) on one block, through the kernels and through the plain
    versions, on the card."""
    from falcon_tpu_torch.store.store import SpectrumStore
    from falcon_tpu_torch.cluster import ann_engine

    store = SpectrumStore(os.path.join(tmp, "whole_path_ann_default"))
    writer = store.writer()
    writer.add_many(rows)
    writer.close()
    dataset = store.dataset(2)
    compare_kernels_with_plain(
        "whole path, ann default index", report, dev, [VEC, PL, K4],
        lambda: ann_engine.generate_clusters(
            dataset, EPS, 2, 0, 20.0, "ppm", None, TOL, 2**15, device=dev),
        len(rows))


def phase_whole_path_new(dev, rows, tmp, report):
    """Phase 5, continued: dbscan mode (default and exact index),
    ``--rerank off`` (linkage and dbscan) and the consensus spectra of the
    default path's clusters on one block, through the kernels and through
    the plain versions, on the card."""
    from falcon_tpu_torch.cluster import ann_engine
    from falcon_tpu_torch.ops import consensus as cs
    from falcon_tpu_torch.preprocess import get_dim
    from falcon_tpu_torch.store.store import SpectrumStore

    store = SpectrumStore(os.path.join(tmp, "whole_path_new"))
    writer = store.writer()
    writer.add_many(rows)
    writer.close()
    dataset = store.dataset(2)

    def cluster(**kw):
        return ann_engine.generate_clusters(
            dataset, EPS, 2, 0, 20.0, "ppm", None, TOL, 2**15, device=dev,
            **kw)

    for name, kw, required in (
            ("dbscan mode", dict(cluster_method="dbscan"), [VEC, PL, B1]),
            ("dbscan mode, exact index",
             dict(cluster_method="dbscan", ann_index="exact"), [K2, B1]),
            ("rerank off, linkage", dict(rerank="off"), [VEC]),
            ("rerank off, dbscan mode",
             dict(rerank="off", cluster_method="dbscan"), [VEC, B2])):
        compare_kernels_with_plain(f"whole path, {name}", report, dev,
                                   required, lambda kw=kw: cluster(**kw),
                                   len(rows))

    _, mz_min, _ = get_dim(101.0, 1500.0, TOL)
    offsets, mz_flat, int_flat = dataset.read_peaks()

    def consensus():
        labels, _ = cluster()
        cons = cs.consensus_spectra(offsets, mz_flat, int_flat, labels, TOL,
                                    mz_min, device=dev)
        packed = np.concatenate([np.concatenate(cons[k]) for k in
                                 sorted(cons)]).view(np.int32)
        return labels, packed

    compare_kernels_with_plain("whole path, consensus spectra", report, dev,
                               [VEC, PL, B3], consensus, len(rows))


def phase_default_ann(name, spectra, truth, tmp, report, required,
                      min_completeness=0.9):
    """Phase 7: the CLI with ``--backend ann`` and its defaults."""
    return phase_main_path(name, spectra, truth, tmp, report, required,
                           ANN_DEFAULT + ["--overwrite"], min_completeness)


def check_repeatable(name, spectra, truth, tmp,
                     flags=tuple(ANN_DEFAULT + ["--overwrite"])):
    """Phases 7 and 8, continued: the CLI run ``name`` again with the same
    flags, work_dir and output; raise unless its CSV (and MGF, where it
    wrote one) has the same bytes."""
    paths = [os.path.join(tmp, f"{name}_out{ext}") for ext in (".csv",
                                                                ".mgf")]
    paths = [p for p in paths if os.path.isfile(p)]
    first = []
    for path in paths:
        with open(path, "rb") as f:
            first.append(f.read())
    run_cli(name, spectra, truth, tmp, flags)
    for path, data in zip(paths, first):
        with open(path, "rb") as f:
            if f.read() != data:
                raise AssertionError(f"{name}: a second run wrote other "
                                     f"bytes to {os.path.basename(path)}")
    log(f"  {name}: a second run wrote the same bytes: " + ", ".join(
        f"{os.path.basename(p)} {len(d)}" for p, d in zip(paths, first)))


def pair_f1(report, name_a, name_b):
    """Pair-F1 of two CLI runs' labels of the same spectra."""
    from falcon_tpu_torch.metrics import pairwise_agreement

    a, b = report["labels"][name_a], report["labels"][name_b]
    ids = sorted(a)
    return pairwise_agreement(np.array([a[i] for i in ids]),
                              np.array([b[i] for i in ids]))


def compare_kernels_with_plain(name, report, dev, required, run, n):
    """Run ``run`` through the kernels, then with every wrapper replaced
    by its plain version; raise unless labels and medoids are identical
    and each kernel in ``required`` was launched."""
    import torch

    pairs = [pair for attrs in wrappers().values() for pair in attrs]
    before = launch_counts()
    t0 = time.perf_counter()
    labels, medoids = run()
    t_kernel = time.perf_counter() - t0
    after = launch_counts()
    for k in required:
        if after[k] == before[k]:
            raise AssertionError(f"{name}: {k} was not launched")
    saved = [getattr(m, a) for m, a in pairs]
    for module, attr in pairs:
        setattr(module, attr, getattr(module, f"{attr}_plain"))
    try:
        t0 = time.perf_counter()
        ref_labels, ref_medoids = run()
        t_plain = time.perf_counter() - t0
    finally:
        for (module, attr), wrapper in zip(pairs, saved):
            setattr(module, attr, wrapper)
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


def phase_new_paths(bench_spectra, bench_truth, dense_spectra, dense_truth,
                    chains, chain_truth, tmp, report):
    """Phase 8: dbscan mode on the three corpora, --rerank off (linkage
    and dbscan) and the consensus export on the bench corpus, at full
    width; returns each run's launch counts.  Purity and completeness are
    printed; only far-off values (wrong distances) fail, since the JAX
    package records no reference for these modes on these corpora."""
    log("== phase 8: main path, dbscan mode, --rerank off, consensus")
    launches = []
    # Spectra/s without representatives, as bench.py times dbscan mode;
    # then the bench corpus again with the medoid MGF, twice.
    for name, spectra, truth in (
            ("dbscan_bench_corpus", bench_spectra, bench_truth),
            ("dbscan_dense_corpus", dense_spectra, dense_truth),
            ("dbscan_chained_corpus", chains, chain_truth)):
        log(f"  {name}")
        launches.append(phase_main_path(
            name, spectra, truth, tmp, report, [VEC, PL, B1],
            DBSCAN + ["--overwrite"], min_completeness=0.0, min_purity=0.5))
    dbscan_flags = DBSCAN + ["--export_representatives", "--overwrite"]
    log("  dbscan_bench_corpus_mgf (medoid MGF export)")
    launches.append(phase_main_path(
        "dbscan_bench_corpus_mgf", bench_spectra, bench_truth, tmp, report,
        [VEC, PL, B1], dbscan_flags, min_completeness=0.0, min_purity=0.5))
    check_repeatable("dbscan_bench_corpus_mgf", bench_spectra, bench_truth,
                     tmp, dbscan_flags)
    log("  exact backend, single linkage (the reference of dbscan mode's "
        "pair-F1)")
    launches.append(phase_main_path(
        "exact_single_bench_corpus", bench_spectra, bench_truth, tmp, report,
        [K4], ["--linkage", "single", "--overwrite"], min_completeness=0.0,
        min_purity=0.5))
    agreement = pair_f1(report, "dbscan_bench_corpus",
                        "exact_single_bench_corpus")
    report["dbscan_vs_single_linkage_bench"] = agreement
    log(f"  dbscan mode against --backend exact --linkage single: pair F1 "
        f"{agreement['f1']:.6f} (precision {agreement['precision']:.6f}, "
        f"recall {agreement['recall']:.6f}; recorded, not asserted)")
    for name, flags, required in (
            ("rerank_off_bench_corpus", RERANK_OFF, [VEC, K4]),
            ("rerank_off_dbscan_bench_corpus", RERANK_OFF
             + ["--cluster_method", "dbscan"], [VEC, B2])):
        log(f"  {name}")
        launches.append(phase_main_path(
            name, bench_spectra, bench_truth, tmp, report, required,
            flags + ["--overwrite"], min_completeness=0.0, min_purity=0.5))
    consensus_flags = ANN_DEFAULT + CONSENSUS + ["--overwrite"]
    log("  consensus_bench_corpus")
    launches.append(phase_main_path(
        "consensus_bench_corpus", bench_spectra, bench_truth, tmp, report,
        [VEC, PL, K4, B3], consensus_flags, min_completeness=0.0))
    check_repeatable("consensus_bench_corpus", bench_spectra, bench_truth,
                     tmp, consensus_flags)
    return launches


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
        phase_whole_path_default(dev, small + chain_rows, tmp, report)
        phase_whole_path_new(dev, small + chain_rows, tmp, report)
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
        log("== phase 7: main path, --backend ann with its defaults")
        log("  bench-shaped corpus")
        launches.append(phase_default_ann(
            "default_ann_bench_corpus", bench_spectra, bench_truth, tmp,
            report, [VEC, PL, K4]))
        agreement = pair_f1(report, "default_ann_bench_corpus",
                            "ann_bench_corpus")
        report["default_vs_ann_exact_bench"] = agreement
        log(f"  pair agreement with phase 6's ann-exact labels: F1 "
            f"{agreement['f1']:.6f} (precision {agreement['precision']:.6f},"
            f" recall {agreement['recall']:.6f})")
        check_repeatable("default_ann_bench_corpus", bench_spectra,
                         bench_truth, tmp)
        log("  dense corpus")
        launches.append(phase_default_ann(
            "default_ann_dense_corpus", dense_spectra, dense_truth, tmp,
            report, [VEC, PL, K4]))
        log("  chained corpus")
        launches.append(phase_default_ann(
            "default_ann_chained_corpus", chains, chain_truth, tmp, report,
            [VEC, PL], min_completeness=0.0))
        launches.extend(phase_new_paths(
            bench_spectra, bench_truth, dense_spectra, dense_truth, chains,
            chain_truth, tmp, report))
    report.pop("labels")

    kernels = [
        {"name": k, "route": "cuda", "source": SOURCES[k],
         "replaces": REPLACES[k],
         "launches": sum(run[k] for run in launches),
         "max_abs_err": errs[k], "ms": times[k]["ms"],
         "plain_ms": times[k]["plain_ms"], "bound_ms": times[k]["bound_ms"],
         "bound_by": times[k]["bound_by"],
         "library_ms": times[k].get("library_ms")}
        for k in KERNELS
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
