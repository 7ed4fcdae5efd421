#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``falcon_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper GPU and
the CUDA toolkit::

    python3 chip_smoke.py [--report PATH]

It builds the port's CUDA kernels from ``falcon_tpu_torch/csrc`` and then:

1. prints the card (``nvidia-smi``), the torch / CUDA versions and the
   kernel build time;
2. holds each kernel against its plain PyTorch version on the same CUDA
   tensors, at the main path's shapes and on a tie-heavy case, and times
   both (CUDA events for kernels, a synchronised host clock for the plain
   versions);
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
error and times, then ``{"ok": true, "device": {...}}``.  JAX is never
imported.
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
    from falcon_tpu.preprocess import process_spectrum

    rows = [process_spectrum(s, 5, 250, 101.0, 1500.0, 1.5, 0.01, 50, None)
            for s in spectra]
    return [r for r in rows if r is not None]


def padded(rows):
    """(n, 64) float32 m/z and intensity of preprocessed rows."""
    from falcon_tpu.store.store import padded_peaks

    offsets = np.zeros(len(rows) + 1, np.int64)
    offsets[1:] = np.cumsum([len(r["mz"]) for r in rows])
    mz, intensity, _ = padded_peaks(
        offsets, np.concatenate([r["mz"] for r in rows]),
        np.concatenate([r["intensity"] for r in rows]), 64)
    return mz, intensity


def kernel_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events),
    after one warm-up launch."""
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
    from falcon_tpu.ms_io.containers import Spectrum

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


def phase_kernels(dev, dense_rows, bench_rows, chain_rows, report):
    """Phase 2: each kernel against its plain version on the card."""
    import torch

    from falcon_tpu_torch.ops import pairwise as pw

    parity = Parity()
    times = {}

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
        times[(k1, shape, "plain")] = t_plain
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
                times[(k1, shape, upper_only, with_matches)] = ms
                log(f"  {k1} {what}: kernel {ms:.2f} ms")

    # K4: intervals of 2..1024 consecutive spectra of the bench corpus,
    # sorted by precursor m/z, in one launch.
    k4 = K4
    mz_b, int_b = padded(bench_rows)
    sizes = list(K4_SIZES)
    starts = np.concatenate([[0], np.cumsum(sizes)])
    mz_g, int_g = cuda(mz_b[:starts[-1]]), cuda(int_b[:starts[-1]])
    starts_t = torch.from_numpy(starts.astype(np.int64)).to(dev)
    n_pairs = sum(m * (m - 1) // 2 for m in sizes)
    want, t_plain = plain_ms(lambda: pw.batched_block_scores_plain(
        mz_g, int_g, starts_t, TOL))
    shape = f"{len(sizes)} intervals, {n_pairs} pairs"
    times[(k4, "plain")] = t_plain
    for with_matches in (True, False):
        def run():
            return pw.batched_block_scores(mz_g, int_g, starts_t, TOL,
                                           with_matches=with_matches)
        got = run()
        parity.check(k4, f"{shape} with_matches={with_matches}", got,
                     want if with_matches else (want[0], None))
    times[(k4, "kernel")] = kernel_ms(
        lambda: pw.batched_block_scores(mz_g, int_g, starts_t, TOL,
                                        with_matches=False), reps=5)
    log(f"  {k4} {shape}: kernel {times[(k4, 'kernel')]:.2f} ms, plain "
        f"version {t_plain:.1f} ms")

    # Tie-heavy spectra through both kernels, with the round cap hit.
    mz_t, int_t = (cuda(a) for a in tie_heavy(128, seed=5))
    for rounds in (1, 8, 32):
        args = (mz_t, int_t, mz_t, int_t, 0, TOL, rounds)
        parity.check(k1, f"tie-heavy 256x256 rounds={rounds}",
                     pw.panel_scores(*args),
                     pw.panel_scores_plain(*args))
        st = torch.tensor([0, 7, 8, 100, 256], device=dev)
        parity.check(k4, f"tie-heavy 4 intervals rounds={rounds}",
                     pw.batched_block_scores(mz_t, int_t, st, TOL, rounds),
                     pw.batched_block_scores_plain(mz_t, int_t, st, TOL,
                                                   rounds))
    phase_banded(dev, parity, times, {"bench": bench_rows,
                                      "dense": dense_rows}, chain_rows)
    report["kernel_times_ms"] = {" | ".join(map(str, k)): v
                                 for k, v in times.items()}
    return parity.err, times


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

    from falcon_tpu.preprocess import get_dim
    from falcon_tpu_torch.ops import pairwise as pw
    from falcon_tpu_torch.ops.knn import _pow2_at_least
    from falcon_tpu_torch.ops.vectorize import SpectrumHasher

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


def phase_banded(dev, parity, times, rows_by_name, chain_rows):
    """Phase 2, continued: K2 and the pair-list launcher."""
    import torch

    from falcon_tpu_torch.ops import exact_knn as ex
    from falcon_tpu_torch.ops import pairwise as pw

    for name, rows in rows_by_name.items():
        mz_r, int_r, mz_p, int_p, starts, window = band_block(rows, dev)
        args = (mz_r, int_r, mz_p, int_p, starts, 0, window, TOL, 4)
        shape = f"{name} {mz_r.shape[0]}x{window}"
        want, t_plain = plain_ms(lambda: ex.banded_panel_scores_plain(*args))
        times[(K2, name, "plain")] = t_plain
        for with_matches in (True, False):
            got = ex.banded_panel_scores(*args, with_matches=with_matches)
            torch.cuda.synchronize()
            parity.check(K2, f"{shape} with_matches={with_matches}", got,
                         want if with_matches else (want[0], None))
        # The main path asks for match counts only with min_matches > 0.
        ms = kernel_ms(lambda: ex.banded_panel_scores(
            *args, with_matches=False), reps=5)
        times[(K2, name, "kernel")] = ms
        log(f"  {K2} {shape}: kernel {ms:.3f} ms, plain version "
            f"{t_plain:.1f} ms ({mz_r.shape[0] * window} pairs)")

    mz, intensity, ids = chain_pair_lists(chain_rows, dev)
    args = (mz, intensity, mz, intensity, ids, TOL, 4)
    shape = (f"chain of {mz.shape[0]}, {ids.shape[1]} slots, "
             f"{int((ids >= 0).sum())} pairs")
    want, t_plain = plain_ms(lambda: pw.pair_list_scores_plain(*args))
    times[(PL, "plain")] = t_plain
    for with_matches in (True, False):
        got = pw.pair_list_scores(*args, with_matches=with_matches)
        torch.cuda.synchronize()
        parity.check(PL, f"{shape} with_matches={with_matches}", got,
                     want if with_matches else (want[0], None))
    times[(PL, "kernel")] = kernel_ms(
        lambda: pw.pair_list_scores(*args, with_matches=False), reps=5)
    log(f"  {PL} {shape}: kernel {times[(PL, 'kernel')]:.3f} ms, plain "
        f"version {t_plain:.1f} ms")

    # Tie-heavy spectra, with the round cap hit.
    mz_t, int_t = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                   for a in tie_heavy(128, seed=6))
    starts = torch.tensor([0, 1] * 64, dtype=torch.int32, device=dev)
    gen = torch.Generator().manual_seed(2)
    ids = torch.randint(0, 256, (128, 24), generator=gen)
    ids[torch.rand(ids.shape, generator=gen) < 0.25] = -1
    ids = ids.to(dev)
    for rounds in (1, 4, 32):
        args = (mz_t[:128], int_t[:128], mz_t, int_t, starts, 0, 128, TOL,
                rounds)
        parity.check(K2, f"tie-heavy 128x128 rounds={rounds}",
                     ex.banded_panel_scores(*args),
                     ex.banded_panel_scores_plain(*args))
        args = (mz_t[:128], int_t[:128], mz_t, int_t, ids, TOL, rounds)
        parity.check(PL, f"tie-heavy 128x24 rounds={rounds}",
                     pw.pair_list_scores(*args),
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
    from falcon_tpu.metrics import cluster_completeness, cluster_purity
    from falcon_tpu.simulate import write_mgf
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
    from falcon_tpu.cluster.intervals import precursor_mz_splits

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
    from falcon_tpu.store.store import SpectrumStore
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
    from falcon_tpu.store.store import SpectrumStore
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
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU is visible", file=sys.stderr)
        return 1
    from falcon_tpu.simulate import make_clustered_spectra
    from falcon_tpu_torch.ops import _build

    report = {}
    card = card_line()
    log("== phase 1: card, versions, build")
    log(card)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    _build.library()
    log(f"  kernel build: {_build.build_seconds or 0.0:.1f} s "
        f"({os.path.relpath(_build.library_path())})")
    # Registers, shared memory and spills of each kernel (-Xptxas -v).
    report.update(card=card, torch=torch.__version__,
                  cuda=torch.version.cuda, build_s=_build.build_seconds,
                  build_log=_build.build_log)

    bench_spectra, bench_truth = make_clustered_spectra(**BENCH_CORPUS)
    dense_spectra, dense_truth = make_clustered_spectra(**DENSE_CORPUS)
    dense_by_charge = {}
    for r in preprocess(dense_spectra):
        dense_by_charge.setdefault(r["precursor_charge"], []).append(r)
    charge2 = sorted(dense_by_charge[2], key=lambda r: r["precursor_mz"])
    bench_rows = sorted(preprocess(bench_spectra[:6000]),
                        key=lambda r: r["precursor_mz"])
    chain_rows = preprocess(chained_spectra(
        1, CHAIN_CORPUS["chain_len"], seed=3)[0])

    log("== phase 2: kernels against their plain versions on the card")
    dev = torch.device("cuda")
    errs, times = phase_kernels(dev, charge2, bench_rows, chain_rows,
                                report)

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

    shapes = {K1: (K1, f"{PANEL_ROWS}x{max(K1_COLS)}", False, True),
              K2: (K2, "dense", "kernel"), K4: (K4, "kernel"),
              PL: (PL, "kernel")}
    plain_shapes = {K1: (K1, f"{PANEL_ROWS}x{max(K1_COLS)}", "plain"),
                    K2: (K2, "dense", "plain"), K4: (K4, "plain"),
                    PL: (PL, "plain")}
    kernels = [
        {"name": k, "route": "cuda", "source": SOURCES[k],
         "replaces": REPLACES[k],
         "launches": sum(run[k] for run in launches),
         "max_abs_err": errs[k], "ms": times[shapes[k]],
         "plain_ms": times[plain_shapes[k]]}
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
