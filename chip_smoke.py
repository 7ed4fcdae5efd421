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
5. clusters a 3,000-spectrum interval through the kernels and through the
   plain versions, both on the GPU, and requires identical labels and
   medoids.

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
SOURCE = "falcon_tpu_torch/csrc/pairwise.cu"
REPLACES = {
    "K1 panel_scores": "falcon_tpu/ops/pairwise.py:44",
    "K4 batched_block_scores": "falcon_tpu/ops/pairwise.py:218",
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


def phase_kernels(dev, dense_rows, bench_rows, report):
    """Phase 2: each kernel against its plain version on the card."""
    import torch

    from falcon_tpu_torch.ops import pairwise as pw

    parity = Parity()
    times = {}

    def cuda(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    mz_all, int_all = padded(dense_rows)
    k1 = "K1 panel_scores"
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
    k4 = "K4 batched_block_scores"
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
    report["kernel_times_ms"] = {" | ".join(map(str, k)): v
                                 for k, v in times.items()}
    return parity.err, times


def read_labels(csv_path: str):
    """spectrum_id -> cluster label from the CLI's CSV."""
    with open(csv_path, newline="") as f:
        rows = csv.DictReader(line for line in f if not line.startswith("#"))
        return {r["spectrum_id"]: int(r["cluster"]) for r in rows}


def run_cli(name, spectra, truth, tmp):
    """Write ``spectra`` as MGF and run the port's CLI on them with its
    defaults; returns (seconds, phase summary, purity, completeness,
    n_clustered)."""
    from falcon_tpu.metrics import cluster_completeness, cluster_purity
    from falcon_tpu.simulate import write_mgf
    from falcon_tpu_torch import cli
    from falcon_tpu_torch.utils.profiling import profiler

    mgf = write_mgf(os.path.join(tmp, f"{name}.mgf"), spectra)
    out = os.path.join(tmp, f"{name}_out")
    t0 = time.perf_counter()
    rc = cli.main([mgf, out, "--work_dir", os.path.join(tmp, f"{name}_work")])
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


def phase_main_path(name, spectra, truth, tmp, report, kernel_name):
    """Phases 3 and 4: the CLI with its defaults; returns the launch
    counts of the run."""
    from falcon_tpu_torch.ops import pairwise as pw

    pw.panel_scores.launches = 0
    pw.batched_block_scores.launches = 0
    seconds, summary, purity, completeness, n = run_cli(
        name, spectra, truth, tmp)
    launches = {"K1 panel_scores": pw.panel_scores.launches,
                "K4 batched_block_scores": pw.batched_block_scores.launches}
    log(f"  {n} spectra clustered in {seconds:.2f} s "
        f"({n / seconds:.0f} spectra/s, ingest included)")
    log(f"  launches: {launches}")
    log(f"  purity {purity:.4f}, completeness {completeness:.4f}")
    log("  phases (s): " + ", ".join(f"{k} {v:.3f}"
                                     for k, v in summary.items()))
    report[name] = dict(seconds=seconds, spectra=n,
                        spectra_per_s=n / seconds, purity=purity,
                        completeness=completeness, phases=summary,
                        launches=launches)
    if launches[kernel_name] <= 0:
        raise AssertionError(f"{name}: {kernel_name} never launched")
    # The exact backend recovers these generators' clusters almost
    # perfectly (the JAX package: purity 1.00, completeness 0.93 on the
    # bench corpus); far lower values mean wrong distances.
    if purity < 0.99 or completeness < 0.9:
        raise AssertionError(f"{name}: purity {purity:.4f}, completeness "
                             f"{completeness:.4f} below 0.99 / 0.9")
    return launches


def phase_whole_path(dev, rows, tmp, report):
    """Phase 5: one interval through the kernels and through the plain
    versions, both on the card."""
    import torch

    from falcon_tpu.store.store import SpectrumStore
    from falcon_tpu_torch.cluster import engine
    from falcon_tpu_torch.ops import pairwise as pw

    store = SpectrumStore(os.path.join(tmp, "whole_path"))
    writer = store.writer()
    writer.add_many(rows)
    writer.close()
    dataset = store.dataset(rows[0]["precursor_charge"])
    args = (dataset, "complete", 0.1, 0, 20.0, "ppm", None, TOL, 2**15)
    launches = pw.panel_scores.launches
    t0 = time.perf_counter()
    labels, medoids = engine.generate_clusters(*args, device=dev)
    t_kernel = time.perf_counter() - t0
    if pw.panel_scores.launches == launches:
        raise AssertionError("whole path: K1 was not launched")
    kernels = pw.panel_scores, pw.batched_block_scores
    pw.panel_scores = pw.panel_scores_plain
    pw.batched_block_scores = pw.batched_block_scores_plain
    try:
        t0 = time.perf_counter()
        ref_labels, ref_medoids = engine.generate_clusters(*args,
                                                           device=dev)
        t_plain = time.perf_counter() - t0
    finally:
        pw.panel_scores, pw.batched_block_scores = kernels
    torch.cuda.synchronize()
    same = (np.array_equal(labels, ref_labels)
            and np.array_equal(medoids, ref_medoids))
    log(f"  {len(rows)} spectra, {len(np.unique(labels))} clusters: labels "
        f"and medoids {'identical' if same else 'DIFFER'} (kernels "
        f"{t_kernel:.2f} s, plain versions {t_plain:.2f} s)")
    report["whole_path"] = dict(spectra=len(rows), identical=same,
                                kernel_s=t_kernel, plain_s=t_plain)
    if not same:
        raise AssertionError("whole path: kernels and plain versions "
                             "disagree on labels or medoids")


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
    report.update(card=card, torch=torch.__version__,
                  cuda=torch.version.cuda, build_s=_build.build_seconds)

    bench_spectra, bench_truth = make_clustered_spectra(**BENCH_CORPUS)
    dense_spectra, dense_truth = make_clustered_spectra(**DENSE_CORPUS)
    dense_by_charge = {}
    for r in preprocess(dense_spectra):
        dense_by_charge.setdefault(r["precursor_charge"], []).append(r)
    charge2 = sorted(dense_by_charge[2], key=lambda r: r["precursor_mz"])
    bench_rows = sorted(preprocess(bench_spectra[:6000]),
                        key=lambda r: r["precursor_mz"])

    log("== phase 2: kernels against their plain versions on the card")
    dev = torch.device("cuda")
    errs, times = phase_kernels(dev, charge2, bench_rows, report)

    with tempfile.TemporaryDirectory(prefix="falcon_chip_smoke_") as tmp:
        log("== phase 3: main path, bench-shaped corpus (small intervals)")
        l3 = phase_main_path("bench_corpus", bench_spectra, bench_truth,
                             tmp, report, "K4 batched_block_scores")
        log("== phase 4: main path, dense corpus (large intervals)")
        big = largest_interval(dense_by_charge)
        log(f"  largest precursor interval: {big} spectra")
        report["dense_largest_interval"] = big
        l4 = phase_main_path("dense_corpus", dense_spectra, dense_truth,
                             tmp, report, "K1 panel_scores")
        log("== phase 5: whole path, kernels against plain versions")
        phase_whole_path(dev, charge2[:3000], tmp, report)

    k1_shape = f"{PANEL_ROWS}x{max(K1_COLS)}"
    kernels = [
        {"name": "K1 panel_scores", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES["K1 panel_scores"],
         "launches": l3["K1 panel_scores"] + l4["K1 panel_scores"],
         "max_abs_err": errs["K1 panel_scores"],
         "ms": times[("K1 panel_scores", k1_shape, False, True)],
         "plain_ms": times[("K1 panel_scores", k1_shape, "plain")]},
        {"name": "K4 batched_block_scores", "route": "cuda",
         "source": SOURCE, "replaces": REPLACES["K4 batched_block_scores"],
         "launches": (l3["K4 batched_block_scores"]
                      + l4["K4 batched_block_scores"]),
         "max_abs_err": errs["K4 batched_block_scores"],
         "ms": times[("K4 batched_block_scores", "kernel")],
         "plain_ms": times[("K4 batched_block_scores", "plain")]},
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
