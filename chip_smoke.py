#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``falcon_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper GPU and
the CUDA toolkit::

    python3 chip_smoke.py [--report PATH] [--root CHECKOUT] [--kernels-only]
                          [--big-bucket N]

``--root`` runs the same phases on the ``falcon_tpu_torch`` of another
checkout (a parent commit unpacked with ``git archive``), so that runs of
two commits, taken in turns on one card, time the same calls.
``--kernels-only`` stops after phase 2 and writes the report, for such
timings of the kernels alone; it prints no result line, since no main path
ran.
``--big-bucket N`` runs phase 1, then only one charge of N spectra (above
2^19 spectra it splits into several device blocks) through the default ann
path, its blocks one at a time and two deep in turns, and prints no result
line either.

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
   which must give the same CSV and MGF bytes;
9. runs the CLI with ``--backend ann --ann_index ivf`` on the bench and
   dense corpora, and with ``--rerank off --cluster_method dbscan`` on the
   bench corpus, prints spectra/s, purity, completeness and the pair-F1
   against phase 6's labels (recorded, not asserted), and runs the bench
   corpus a second time, which must give the same CSV bytes.
10. runs ``--devices N`` on N virtual shards of the card
    (``FALCON_TPU_TORCH_VIRTUAL_DEVICES``): first one shard's pair lists
    against its halo pool (queries and pool apart) and B.2's sums and dots
    alone, at the bench corpus's charge-2 block in 4 shards, bit for bit
    against their plain versions; then the CLI's default ann path on the
    bench and dense corpora at 2 and 4 shards, dbscan mode and ``--rerank
    off`` on the bench corpus at 4, each of which must give the labels of
    the one-device run of its mode (phases 7 and 8), and the 4-shard
    dbscan run a second time (the same bytes); the bench corpus in blocks
    of 8,192 spectra, one at a time and two deep in turns (1, 2, 2, 1;
    ``FALCON_TPU_BLOCK_PIPELINE``), which must write the same CSV bytes
    with block gauges of 1 and 2, with each run's time and peak device
    memory; and a ``torch.profiler`` split of one sharded dbscan run, in
    which the plain pair-list version raises and the pair-list, vectorize
    and B.2 kernels must run.  The sharded searches' launch shapes are held
    against their plain versions bit for bit and timed: K1 on each shard's
    condensed slice (4 shards of a 3,000-spectrum dense interval; shard 1
    of the whole dense interval timed), the pair lists on shard 1's
    windowed halo pool (the exact index on the bench block in 4 shards),
    and IVF.1 on the IVF ring's steps (shard 1 at step 1 beside PyTorch's
    gather + einsum + mask + sort, the ring against the ring on plain
    versions, its device time against the one-device self-search); then
    the CLI's exact backend on the dense corpus, ``--ann_index exact`` on
    the bench and dense corpora and ``--ann_index ivf`` on both, at 2 and
    4 shards, and IVF with ``--rerank off --cluster_method dbscan`` at 4:
    the exact backend and index must give the one-device labels (phases 4
    and 6), IVF a pair-F1 of 1.0 against phase 9's; last,
    ``multichip_cluster_step`` on the bench block in 4 shards (its exact
    tile against K1's plain version) and ``graft_entry.dryrun_multichip(4)``.
11. holds K4's pair kernel against the host oracle (``cluster/oracle.py``,
    the optimal assignment) on spectra whose peaks each have at most one
    partner, then runs the CLI under each of the JAX package's switches
    that change the result: ``FALCON_TPU_KNN_DTYPE=f32`` (linkage, and
    dbscan mode with its medoid MGF), ``FALCON_TPU_IVF_COARSE=plain`` and
    ``FALCON_TPU_IVF_RANK=cos`` (IVF.1 and IVF.2 must launch),
    ``FALCON_TPU_LINKAGE_GROUP_MAX=8``, ``FALCON_TPU_MAX_NEIGHBORS=128`` and
    ``FALCON_TPU_NO_CHARGE_OVERLAP=1`` (the labels of phase 7's run) on the
    bench corpus, and ``FALCON_TPU_LINKAGE_PRUNE=0`` with single and
    complete linkage on the chained corpus (K1 must launch; the time
    against a pruned run with the same flags).  Each run is repeated (the
    same CSV and MGF bytes) and run on the plain versions (the same labels
    and MGF); the pair-F1 against phase 6 and against the same mode
    without the switch is recorded, not asserted.

Phase 2 also holds the vectorize kernel (one output, and the fused plain +
spread call) against its plain version at the bench corpus's charge-2 block
(bit for bit, and two launches against each other), times it beside the
``index_add_`` it replaces, times the default path's scan (product and
top-k apart) and rerank (pair-list kernel and sort apart) at that block,
and holds the medoid-score kernels (on that block's lists and unit
vectors) and the consensus kernel (on its consensus input) against their
plain versions bit for bit, timed beside a PyTorch computation of the same
function on ``index_add_``; B.1, B.2 and B.3 also on a skewed input each
(hub targets, a cluster of 3,000 rows, a hot key), with their device time
split by ``torch.profiler`` into the group-by and the walk (B.2: the
cluster sums and the row dots), which must hold no sort or search
kernel; phase 2 also holds the IVF probe scan's chunk step (IVF.1: mask,
dots and stable top-k) at the bench corpus's charge-2 block and at a dense
block, and the IVF k-means update (IVF.2) at the bench block's training
sample and with one list of 20,000 of its rows, against their plain
versions bit for bit, timed beside a gather + einsum + mask + stable sort
and a one-hot product, with a torch.profiler split of the index's
self-search and of IVF.2 that must hold no sort or top-k kernel, and times
the self-search (lists kept on the card) and ``search`` (copied to the
host);
phase 5 also runs the default index, dbscan mode, ``--rerank off``, the
consensus spectra and the IVF index through the kernels and through the
plain versions.

Every phase raises on failure, so the script exits non-zero; it also exits
non-zero, printing no result, without a CUDA GPU.  On success the last two
lines of standard output are one JSON object with each kernel's launches,
error, times and bound, then ``{"ok": true, "device": {...}}``.  Neither
JAX nor the JAX package is ever imported.
"""

import argparse
import contextlib
import csv
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

TOL = 0.05            # the CLI's default --fragment_tol
# Permuted peaks against the originals: the same matching, its weights
# summed in another order (the 32 x 32 blocks hold other entries).
PERMUTED_ATOL = 1e-6
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
IVF1, IVF2 = "IVF.1 probe_topk", "IVF.2 kmeans_update"
KERNELS = (K1, K2, K4, PL, VEC, B1, B2, B3, IVF1, IVF2)
SOURCES = {K1: "falcon_tpu_torch/csrc/pairwise.cu",
           K2: "falcon_tpu_torch/csrc/exact_knn.cu",
           K4: "falcon_tpu_torch/csrc/pairwise.cu",
           PL: "falcon_tpu_torch/csrc/pairwise.cu",
           VEC: "falcon_tpu_torch/csrc/vectorize.cu",
           B1: "falcon_tpu_torch/csrc/medoids.cu",
           B2: "falcon_tpu_torch/csrc/medoids.cu",
           B3: "falcon_tpu_torch/csrc/consensus.cu",
           IVF1: "falcon_tpu_torch/csrc/ivf.cu",
           IVF2: "falcon_tpu_torch/csrc/ivf.cu"}
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
    IVF1: "falcon_tpu/ops/ivf.py:550",
    IVF2: "falcon_tpu/ops/ivf.py:63",
}
DBSCAN = ANN_DEFAULT + ["--cluster_method", "dbscan"]
RERANK_OFF = ANN_DEFAULT + ["--rerank", "off"]
CONSENSUS = ["--export_representatives", "--representative_method",
             "consensus"]
IVF = ANN_DEFAULT + ["--ann_index", "ivf"]
BLOCK_CAP = 8192  # phase 10's device blocks: 4 a bench-corpus charge
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
    """Largest kernel-vs-plain score difference per kernel; raises unless
    the scores are the plain version's bits (both add in XLA's CPU order,
    ``ops/matching.py``) and the match counts equal, and, given ``again``
    (a second launch's result), unless it is the same bits."""

    def __init__(self):
        self.err = {}

    def check(self, name, what, got, want, again=None):
        import torch

        s, m = got
        ws, wm = want
        err = float((s - ws).abs().max()) if s.numel() else 0.0
        self.err[name] = max(self.err.get(name, 0.0), err)
        if not torch.equal(s, ws):
            raise AssertionError(f"{name} {what}: scores not bit-identical "
                                 f"to the plain version's (max |diff| "
                                 f"{err:.3g})")
        if (m is None) != (wm is None) or (
                m is not None and not torch.equal(m, wm)):
            raise AssertionError(f"{name} {what}: match counts differ")
        if again is not None and not (
                torch.equal(again[0], s)
                and (m is None or torch.equal(again[1], m))):
            raise AssertionError(f"{name} {what}: a second launch differs")
        log(f"  {name} {what}: scores bit-identical"
            f"{' (and to a second launch)' if again is not None else ''}, "
            f"match counts {'equal' if m is not None else 'not requested'}")


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
    from falcon_tpu_torch.ops import ivf
    from falcon_tpu_torch.ops import medoids as md
    from falcon_tpu_torch.ops import pairwise as pw
    from falcon_tpu_torch.ops import vectorize as vz

    return {K1: [(pw, "panel_scores")], K2: [(ex, "banded_panel_scores")],
            K4: [(pw, "batched_block_scores")],
            PL: [(pw, "pair_list_scores")],
            VEC: [(vz, "vectorize"), (vz, "vectorize_pair")],
            B1: [(md, "sparse_medoid_scores")],
            # B.2's sums and dots alone (the sharded medoid scores), where
            # the package (another checkout through --root) has them.
            B2: [(md, a) for a in ("hashed_medoid_scores", "segment_sums",
                                   "segment_dots") if hasattr(md, a)],
            B3: [(cs, "aggregate")],
            IVF1: [(ivf, "probe_topk")], IVF2: [(ivf, "kmeans_update")]}


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
    matching, summed in another order."""
    import torch

    err = float((got[0] - original[0]).abs().max())
    if err > PERMUTED_ATOL or not torch.equal(got[1], original[1]):
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
                got, again = run(), run()
                torch.cuda.synchronize()
                ref = want_upper if upper_only else want
                ref = ref if with_matches else (ref[0], None)
                what = (f"{shape} row_offset={r0} upper_only={upper_only} "
                        f"with_matches={with_matches}")
                parity.check(k1, what, got, ref, again)
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
    phase_ivf_kernels(dev, parity, times, report, bench_all, dense_rows)
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
            got, again = (pw.batched_block_scores(
                mz, intensity, starts, TOL, with_matches=with_matches)
                for _ in range(2))
            parity.check(K4, f"{shape} with_matches={with_matches}", got,
                         want if with_matches else (want[0], None), again)
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
            got, again = (ex.banded_panel_scores(
                *args, with_matches=with_matches) for _ in range(2))
            torch.cuda.synchronize()
            parity.check(K2, f"{shape} with_matches={with_matches}", got,
                         want if with_matches else (want[0], None), again)
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
        got, again = (pw.pair_list_scores(*args, 4, with_matches=with_matches)
                      for _ in range(2))
        torch.cuda.synchronize()
        parity.check(PL, f"{shape} with_matches={with_matches}", got,
                     want if with_matches else (want[0], None), again)
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


def groupby_split(name, fn, walk, other, sort_free=None):
    """Device milliseconds per call of a B.1 / B.2 / B.3 wrapper
    (torch.profiler), summed into the walk (the kernels named in ``walk``:
    B.1's and B.3's with the short groups' order fused in, B.2's cluster
    sums), ``other`` kernels, and the group-by (all the rest: zeroing,
    counts, scans, fill, the order); raises if a sort or a search ran,
    unless ``sort_free`` (default ``GROUPBY_FREE``) is false: an older
    package, whose sorts are only logged."""
    split = device_split(fn, reps=10)
    log_split(name, split)
    if not split:
        return {}
    if sort_free is None:
        sort_free = GROUPBY_FREE
    banned = [k for k in split if "sort" in k.lower() or "search" in k.lower()]
    if banned and not sort_free:  # an older package (--root)
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


def skewed_hashed(args):
    """B.2 on the block's unit vectors with the first 3,000 rows made one
    cluster (a block's sum of 3,000 rows, and a block's sort of their ids
    in the group-by); bit for bit against the plain version and across two
    launches, timed, with its device split."""
    from falcon_tpu_torch.ops import medoids as md

    unit, seg, spill = args
    seg = seg.clone()
    m = min(3000, seg.shape[0])
    seg[:m] = 0
    skewed = (unit, seg, spill)
    got = md.hashed_medoid_scores(*skewed)
    again = md.hashed_medoid_scores(*skewed)
    shape = f"{seg.shape[0]} rows x {unit.shape[1]}, a cluster of {m}"
    check_bits(B2, shape, got, again, md.hashed_medoid_scores_plain(*skewed))
    ms = kernel_ms(lambda: md.hashed_medoid_scores(*skewed), reps=10)
    log(f"  {B2} {shape}: wrapper {ms:.4f} ms, bit-identical to the plain "
        f"version and across two launches")
    split = groupby_split(f"{B2} {shape}",
                          lambda: md.hashed_medoid_scores(*skewed),
                          ("hashed_medoid_sums", "hashed_medoid_kernel"),
                          ("hashed_medoid_dot",),
                          sort_free=hasattr(md, "_cluster_rows"))
    return dict(ms=ms, cluster=m, split=split)


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
    # Packages before B.2's group-by (a parent through --root) sort: timed
    # and split, their sorts logged, not failed.
    split = groupby_split(B2, lambda: md.hashed_medoid_scores(*args),
                          ("hashed_medoid_sums", "hashed_medoid_kernel"),
                          ("hashed_medoid_dot",),
                          sort_free=hasattr(md, "_cluster_rows"))
    times[B2] = dict(ms=ms, plain_ms=t_plain, library_ms=library,
                     bound_ms=n_bytes / HBM_BYTES_PER_S * 1e3,
                     bound_by="bytes")
    report[f"{B2} split"] = split
    parity.err[B2] = 0.0
    log(f"  {B2} {shape}: wrapper {ms:.4f} ms (group-by, sums, dots), "
        f"bit-identical to the plain version and across two launches; plain "
        f"version {t_plain:.1f} ms; index_add_ + row dot {library:.4f} ms "
        f"(max |diff| {lib_err:.3g} on the rows read); bound "
        f"{times[B2]['bound_ms']:.5f} ms (bytes)")
    report["B.2 skewed"] = skewed_hashed(args)

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


def probe_topk_library(q3d, qmz3d, qrow3d, corpus3d, cmz3d, crow3d,
                       probe_ids, tol, tol_is_da, k, c0, chunk):
    """IVF.1's chunk step as PyTorch computes it: the probed slabs gathered
    into a (chunk, n_probe, lb, D) copy, one einsum (bf16 operands give a
    bf16 result, widened), the same mask, ``stable_topk`` (``torch.sort``)
    over each row's n_probe * lb scores and the slot of each position."""
    import torch

    from falcon_tpu_torch.ops import knn

    qlb, lb = q3d.shape[1], corpus3d.shape[1]
    probes = probe_ids[c0:c0 + chunk].long()
    sims = torch.einsum("cqd,cpbd->cqpb", q3d[c0:c0 + chunk],
                        corpus3d[probes]).float()
    valid = probe_mask(qmz3d, qrow3d, cmz3d, crow3d, probes, tol, tol_is_da,
                       c0, chunk)
    top, pos = knn.stable_topk(torch.where(valid, sims, -2.0).view(
        chunk * qlb, -1), k)
    slot = torch.gather(probes.repeat_interleave(qlb, 0), 1,
                        pos // lb) * lb + pos % lb
    return (top.view(chunk, qlb, k),
            torch.where(top > -2.0, slot, -1).int().view(chunk, qlb, k))


def probe_mask(qmz3d, qrow3d, cmz3d, crow3d, probes, tol, tol_is_da, c0,
               chunk):
    """The (chunk, qlb, n_probe, lb) pairs of the lists [c0, c0 + chunk)
    that IVF.1 scores (in band, real, not the self pair)."""
    import torch

    qm = qmz3d[c0:c0 + chunk][:, :, None, None]
    sm = cmz3d[probes][:, None]
    diff = qm - sm
    mass = diff.abs() if tol_is_da else (diff / sm * 1e6).abs()
    return (torch.isfinite(qm) & torch.isfinite(sm) & (mass <= tol)
            & (qrow3d[c0:c0 + chunk][:, :, None, None]
               != crow3d[probes][:, None]))


def kmeans_update_library(vectors, assign, centroids):
    """IVF.2 as PyTorch computes it: a one-hot float32 product (TF32 off)
    for the sums and counts, then the renormalisation."""
    import torch

    one_hot = torch.nn.functional.one_hot(
        assign.long(), centroids.shape[0]).float()
    sums = one_hot.t() @ vectors
    new = torch.where(one_hot.sum(0)[:, None] > 0, sums, centroids)
    return new / torch.linalg.norm(new, dim=1, keepdim=True).clamp_min(1e-12)


def kernel_split(name, fn, kernel, banned=("sort", "search"), reps=3):
    """Device milliseconds per call of ``fn`` (torch.profiler) summed into
    ``kernel`` (the kernels whose names hold it), the sorts, the group-by
    (``groupby`` and ``order_long`` kernels) and the rest; raises if a
    kernel named by ``banned`` ran."""
    split = device_split(fn, reps=reps)
    log_split(name, split)
    if not split:
        return {}
    ran = [k for k in split if any(b in k.lower() for b in banned)]
    if ran:
        raise AssertionError(f"{name}: {ran} ran")

    def total(*words):
        return sum(v for k, v in split.items()
                   if any(w in k.lower() for w in words))

    out = dict(device_ms=sum(split.values()), kernel_ms=total(kernel),
               sort_ms=total("sort"), groupby_ms=total("groupby",
                                                       "order_long"))
    out["other_ms"] = (out["device_ms"] - out["kernel_ms"] - out["sort_ms"]
                       - out["groupby_ms"])
    log(f"  {name} device time: {out['device_ms']:.4f} ms = {kernel} "
        f"{out['kernel_ms']:.4f} + sorts {out['sort_ms']:.4f} + group-by "
        f"{out['groupby_ms']:.4f} + other {out['other_ms']:.4f} ms")
    out["kernels"] = split
    return out


def ivf_index(mz, intensity, pmz, dev):
    """The block's IVF index as ``--ann_index ivf`` builds it under the
    default ``--rerank exact`` (bf16 slabs of the unnormalised plain
    vectors, spread rank vectors, the normalised spread space for the
    quantizer), the scan's arguments (q3d, m/z, rows, slabs, m/z, rows,
    probe ids on ``dev``) and its chunk."""
    import torch

    from falcon_tpu_torch.ops import ivf
    from falcon_tpu_torch.ops import vectorize as vz
    from falcon_tpu_torch.preprocess import get_dim

    _, mz_min, mz_max = get_dim(101.0, 1500.0, TOL)
    hasher = vz.SpectrumHasher(mz_min, mz_max, TOL)
    plain, spread = hasher.vectorize_pair(mz, intensity)
    index = ivf.IVFIndex(plain, pmz, coarse_vectors=vz.normalize_rows(spread),
                         rank_vectors=spread)
    n_probe, lb = min(32, index.n_lists), index._lb
    chunk = ivf.scan_chunk(index.n_lists, lb, n_probe, lb)
    args = (index._query3d, index._mz3d, index._row3d, index._corpus3d,
            index._mz3d, index._row3d,
            torch.from_numpy(index._probe_ids(n_probe)).to(dev))
    return index, plain, args, chunk


def phase_ivf_kernels(dev, parity, times, report, bench_all, dense_rows):
    """Phase 2, continued: the IVF probe scan's chunk step (IVF.1) at the
    bench corpus's charge-2 block and at a dense block, at the engine's k
    and chunks, and the k-means update (IVF.2) at the bench block's
    training sample and with one list of 20,000 of its rows, each bit for
    bit against its plain version and its own second launch, timed beside
    a PyTorch computation of the same function (gather + einsum + mask +
    stable sort; a one-hot product), with its bound and a torch.profiler
    split (the self-search's must hold no sort or top-k kernel, IVF.2's no
    sort or search kernel); and the index's self-search and ``search``
    timed."""
    import torch

    from falcon_tpu_torch.cluster import ann_engine
    from falcon_tpu_torch.ops import ivf
    from falcon_tpu_torch.ops import vectorize as vz
    from falcon_tpu_torch.ops.knn import _pow2_at_least
    from falcon_tpu_torch.preprocess import get_dim

    dense = sorted(dense_rows, key=lambda r: r["precursor_mz"])
    n_dense = _pow2_at_least(len(dense), 512)
    mz_d = np.full((n_dense, 64), -1e6, np.float32)
    int_d = np.zeros((n_dense, 64), np.float32)
    mz_d[:len(dense)], int_d[:len(dense)] = padded(dense)
    blocks = {"bench": bench_block(bench_all, dev),
              "dense": (torch.from_numpy(mz_d).to(dev),
                        torch.from_numpy(int_d).to(dev),
                        np.asarray([r["precursor_mz"] for r in dense]))}
    for name, (mz, intensity, pmz) in blocks.items():
        t0 = time.perf_counter()
        index, plain, args, chunk = ivf_index(mz, intensity, pmz, dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        n, lb, n_lists = len(pmz), index._lb, index.n_lists
        n_probe, dim = args[-1].shape[1], plain.shape[1]
        if name == "bench":
            n_lists_bench = n_lists
        # The engine's search width at the CLI's defaults (n_neighbors 64,
        # n_neighbors_ann 128, 20 ppm).
        _, k_ivf = ann_engine.ivf_widths(
            ann_engine.band_spans(pmz, 20.0, "ppm"), 64, 128, True)
        k = min(k_ivf, n_probe * lb)

        def self_search():
            return index.self_search(k_ivf, n_probe=32, tol_mass=20.0,
                                     tol_mode="ppm")

        def search():
            return index.search(plain, pmz, np.arange(n, dtype=np.int32),
                                k_ivf, n_probe=32, tol_mass=20.0,
                                tol_mode="ppm")

        # The engine's step over the whole block (every chunk, with the
        # casts and the concatenation), and search's NumPy contract (the
        # lists copied to the host), each after a warm-up.
        step_ms = kernel_ms(lambda: ivf._chunk_scan(
            *args, 20.0, k, False, chunk, lb, lb, n_probe), reps=3)
        search()
        search_s = plain_ms(search)[1] / 1e3
        log(f"  {IVF1} {name} block: the engine's chunk step over "
            f"{n_lists} lists (chunks of {chunk}) {step_ms:.4f} ms; search "
            f"(k={k_ivf}) {search_s:.4f} s")
        report[f"{IVF1} {name} step"] = dict(step_ms=step_ms, chunk=chunk,
                                             search_s=search_s)
        calls = [args + (20.0, False, k, c0, chunk)
                 for c0 in range(0, n_lists, chunk)]
        n_valid = 0
        most = 0  # the most in-band pairs of a row
        # Bytes the chunk step must move: each query slot's m/z and row,
        # the vector of each query slot with a pair in band, each distinct
        # probed slab slot's m/z and row, the vector of each distinct slab
        # slot with a pair in band, the probe ids, and the (qlb, k) scores
        # and slots written; counted a chunk, from this run's mask.
        n_bytes = 0
        for call in calls:
            c0 = call[-2]
            got, again = ivf.probe_topk(*call), ivf.probe_topk(*call)
            want = ivf.probe_topk_plain(*call)
            check_bits(IVF1, f"{name} block, lists {c0}+{chunk}, "
                       f"k = {k}", got, again, want)
            probes = args[6][c0:c0 + chunk].long()
            valid = probe_mask(*args[1:3], *args[4:6], probes, 20.0, False,
                               c0, chunk)
            n_valid += int(valid.sum())
            per_row = valid.flatten(2).sum(-1)
            most = max(most, int(per_row.max()))
            hit = torch.zeros((n_lists, lb), dtype=torch.int32, device=dev)
            hit.index_put_((probes.flatten(),),
                           valid.any(1).flatten(0, 1).int(), accumulate=True)
            n_bytes += (chunk * lb * 8 + int((per_row > 0).sum()) * dim * 2
                        + int(torch.unique(probes).numel()) * lb * 8
                        + int((hit > 0).sum()) * dim * 2
                        + probes.numel() * 4 + chunk * lb * k * 8)
        n_pairs = n_lists * lb * n_probe * lb
        shape = (f"{name} block: {n} spectra, {n_lists} lists of {lb} slots,"
                 f" {n_probe} probes, k = {k}, chunks of {chunk} lists, "
                 f"20 ppm, {n_valid} of {n_pairs} pairs in band (at most "
                 f"{most} a row)")
        ms = kernel_ms(lambda: [ivf.probe_topk(*c) for c in calls],
                       reps=5) / len(calls)
        _, t_plain = plain_ms(lambda: [ivf.probe_topk_plain(*c)
                                       for c in calls])
        library = kernel_ms(lambda: [probe_topk_library(*c) for c in calls],
                            reps=3) / len(calls)
        lib_err = max(float((probe_topk_library(*c)[0] - ivf.probe_topk(*c)
                             [0]).abs().max()) for c in calls)
        # Operations: a dot of bf16 operands per pair in band, and the
        # mask's few per pair.
        op_ms = (n_valid * 2 * dim / BF16_OPS_PER_S
                 + n_pairs * 6 / F32_OPS_PER_S) * 1e3 / len(calls)
        byte_ms = n_bytes / HBM_BYTES_PER_S * 1e3 / len(calls)
        bound_ms, bound_by = max((byte_ms, "bytes"), (op_ms, "operations"))

        # The engine's call: the lists stay on the card.
        self_search()
        self_search_s = plain_ms(self_search)[1] / 1e3
        split = kernel_split(f"{IVF1} {name} self-search", self_search,
                             "ivf_", banned=("sort", "topk", "radixselect"),
                             reps=2)
        entry = dict(ms=ms, plain_ms=t_plain / len(calls),
                     library_ms=library, bound_ms=bound_ms,
                     bound_by=bound_by, chunks=len(calls), chunk=chunk,
                     in_band_pairs=n_valid, most_in_band=most, pairs=n_pairs,
                     lists=n_lists, lb=lb, k=k, build_s=build_s,
                     step_ms=step_ms, self_search_s=self_search_s,
                     search_s=search_s, split=split)
        report[f"{IVF1} {name}"] = entry
        if name == "bench":
            times[IVF1] = {k: entry[k] for k in ("ms", "plain_ms",
                                                 "library_ms", "bound_ms",
                                                 "bound_by")}
        log(f"  {IVF1} {shape}: {ms:.4f} ms a chunk ({ms * len(calls):.3f} "
            f"ms the block), bit-identical to the plain version and across "
            f"two launches; plain version {t_plain / len(calls):.1f} ms a "
            f"chunk; gather + einsum + mask + stable_topk {library:.4f} ms "
            f"(max |diff| {lib_err:.3g}); bound {bound_ms:.5f} ms "
            f"({bound_by}, {100 * bound_ms / ms:.1f}%); index built in "
            f"{build_s:.2f} s, self-search (k={k_ivf}) {self_search_s:.4f} "
            f"s, search with the host copy {search_s:.4f} s")
        if name == "bench":
            # Every pair in band (tol = inf), one chunk: each row's 8,192
            # pairs take the block's radix select.
            call = args + (float("inf"), True, k, 0, chunk)
            got, again = ivf.probe_topk(*call), ivf.probe_topk(*call)
            check_bits(IVF1, f"{name} block, every pair in band, lists "
                       f"0+{chunk}, k = {k}", got, again,
                       ivf.probe_topk_plain(*call))
            inf_ms = kernel_ms(lambda: ivf.probe_topk(*call), reps=2)
            inf_library = kernel_ms(lambda: probe_topk_library(*call), reps=2)
            entry.update(every_pair_ms=inf_ms,
                         every_pair_library_ms=inf_library)
            log(f"  {IVF1} {name} block, every pair in band: {inf_ms:.4f} ms"
                f" a chunk; gather + einsum + mask + stable_topk "
                f"{inf_library:.4f} ms")
        del calls, got, again, want, valid
    parity.err[IVF1] = 0.0

    # IVF.2 at the bench block's training sample, from its initial rows,
    # as the index trains: the normalised spread vectors.
    mz, intensity, pmz = blocks["bench"]
    n, n_lists = len(pmz), n_lists_bench
    _, mz_min, mz_max = get_dim(101.0, 1500.0, TOL)
    coarse = vz.normalize_rows(vz.SpectrumHasher(mz_min, mz_max, TOL)
                               .vectorize(mz, intensity, norm=False,
                                          spread=True))
    sample = min(ivf._bucket(n_lists * 128, 1024), ivf._bucket(n, 512))
    train_rows = (np.arange(sample) * max(n // sample, 1)) % n
    init_rows = np.random.default_rng(42).choice(n, n_lists, replace=False)
    train = coarse[torch.from_numpy(train_rows).to(dev)].contiguous()
    centroids = coarse[torch.from_numpy(init_rows).to(dev)]
    assign = torch.argmax(train @ centroids.t(), dim=1).int()
    args = (train, assign, centroids)
    got = ivf.kmeans_update(*args)
    again = ivf.kmeans_update(*args)
    want, t_plain = plain_ms(lambda: ivf.kmeans_update_plain(*args))
    sizes = torch.bincount(assign.long(), minlength=n_lists)
    shape = (f"{sample} x {train.shape[1]} training rows, {n_lists} lists "
             f"(largest {int(sizes.max())}, {int((sizes == 0).sum())} empty)")
    check_bits(IVF2, shape, got, again, want)
    ms = kernel_ms(lambda: ivf.kmeans_update(*args), reps=20)
    library = kernel_ms(lambda: kmeans_update_library(*args), reps=20)
    lib_err = float((kmeans_update_library(*args) - got).abs().max())
    n_bytes = (train.numel() * 4 + assign.numel() * 4
               + 2 * centroids.numel() * 4)
    bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    split = kernel_split(IVF2, lambda: ivf.kmeans_update(*args), "kmeans",
                         reps=10)
    fit_ms = kernel_ms(lambda: ivf._kmeans_fit(train, centroids, n_lists,
                                               10), reps=2)
    times[IVF2] = dict(ms=ms, plain_ms=t_plain, library_ms=library,
                       bound_ms=bound_ms, bound_by="bytes")
    device_ms = split.get("device_ms")
    # One list of 20,000 of the sample's rows: one block adds them all.
    n_hot = min(20000, sample)
    hot = assign.clone()
    hot[torch.from_numpy(np.random.default_rng(7).choice(
        sample, n_hot, replace=False)).to(dev)] = 1
    hot_args = (train, hot, centroids)
    check_bits(IVF2, f"{shape}, one list of {n_hot} rows",
               ivf.kmeans_update(*hot_args), ivf.kmeans_update(*hot_args),
               ivf.kmeans_update_plain(*hot_args))
    hot_ms = kernel_ms(lambda: ivf.kmeans_update(*hot_args), reps=5)
    report[IVF2] = dict(times[IVF2], split=split, fit_10_steps_ms=fit_ms,
                        rows=sample, lists=n_lists, hot_list_rows=n_hot,
                        hot_list_ms=hot_ms,
                        device_ms=device_ms, bound_share_of_device=(
                            bound_ms / device_ms if device_ms else None))
    parity.err[IVF2] = 0.0
    log(f"  {IVF2} {shape}: wrapper {ms:.4f} ms (counts, scan, fill, sums "
        f"and renormalisation), bit-identical to the plain version and "
        f"across two launches; plain version {t_plain:.1f} ms; one-hot "
        f"product {library:.4f} ms (max |diff| {lib_err:.3g}); bound "
        f"{bound_ms:.5f} ms (bytes)"
        + (f", {100 * bound_ms / device_ms:.1f}% of the device time "
           f"{device_ms:.4f} ms" if device_ms else "")
        + f"; 10 Lloyd steps {fit_ms:.3f} ms; one list of {n_hot} rows "
        f"{hot_ms:.4f} ms")


def read_labels(csv_path: str):
    """spectrum_id -> cluster label from the CLI's CSV."""
    with open(csv_path, newline="") as f:
        rows = csv.DictReader(line for line in f if not line.startswith("#"))
        return {r["spectrum_id"]: int(r["cluster"]) for r in rows}


# Each corpus's MGF, written once a temporary directory: (tmp, id of the
# spectra) -> (spectra, path); the spectra are held so that their id stays.
_INPUTS = {}


def run_cli(name, spectra, truth, tmp, flags=()):
    """Write ``spectra`` as MGF (once for each list of spectra) and run the
    port's CLI on them with its defaults and ``flags``; returns (seconds,
    phase summary, purity, completeness, labels by spectrum id)."""
    from falcon_tpu_torch.metrics import cluster_completeness, cluster_purity
    from falcon_tpu_torch.simulate import write_mgf
    from falcon_tpu_torch import cli
    from falcon_tpu_torch.utils.profiling import profiler

    key = (tmp, id(spectra))
    if key not in _INPUTS:
        _INPUTS[key] = (spectra, write_mgf(os.path.join(tmp, f"{name}.mgf"),
                                           spectra))
    mgf = _INPUTS[key][1]
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
             dict(rerank="off", cluster_method="dbscan"), [VEC, B2]),
            ("ivf index", dict(ann_index="ivf"), [VEC, IVF1, IVF2, PL]),
            ("ivf index, rerank off, dbscan mode",
             dict(ann_index="ivf", rerank="off", cluster_method="dbscan"),
             [VEC, IVF1, IVF2, B2])):
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


def phase_ivf_paths(bench_spectra, bench_truth, dense_spectra, dense_truth,
                    tmp, report):
    """Phase 9: ``--backend ann --ann_index ivf`` on the bench and dense
    corpora with its defaults, and on the bench corpus with ``--rerank off
    --cluster_method dbscan``, at full width; returns each run's launch
    counts.  The pair-F1 against phase 6's ann-exact labels is recorded,
    not asserted (the index probes a share of the lists, so it may miss
    neighbours), and so is the pair-F1 against phase 7's or 8's run of the
    same mode on the default index; purity is held to the floor of the
    other ann phases in the same mode, and a second bench run must write
    the same CSV bytes."""
    log("== phase 9: main path, --backend ann --ann_index ivf")
    launches = []
    off_dbscan = ["--rerank", "off", "--cluster_method", "dbscan"]
    for name, spectra, truth, flags, required, min_purity, same_mode in (
            ("ivf_bench_corpus", bench_spectra, bench_truth, IVF,
             [VEC, IVF1, IVF2, PL, K4], 0.99, "default_ann_bench_corpus"),
            ("ivf_dense_corpus", dense_spectra, dense_truth, IVF,
             [VEC, IVF1, IVF2, PL], 0.99, "default_ann_dense_corpus"),
            ("ivf_rerank_off_dbscan_bench_corpus", bench_spectra,
             bench_truth, IVF + off_dbscan, [VEC, IVF1, IVF2, B2], 0.5,
             "rerank_off_dbscan_bench_corpus")):
        log(f"  {name}")
        launches.append(phase_main_path(
            name, spectra, truth, tmp, report, required,
            flags + ["--overwrite"], min_completeness=0.0,
            min_purity=min_purity))
        ref = "ann_dense_corpus" if "dense" in name else "ann_bench_corpus"
        for other in (ref, same_mode):
            agreement = pair_f1(report, name, other)
            report[f"{name}_vs_{other}"] = agreement
            log(f"  pair agreement with {other}'s labels: F1 "
                f"{agreement['f1']:.6f} (precision "
                f"{agreement['precision']:.6f}, recall "
                f"{agreement['recall']:.6f}; recorded, not asserted)")
    check_repeatable("ivf_bench_corpus", bench_spectra, bench_truth, tmp,
                     tuple(IVF + ["--overwrite"]))
    return launches


@contextlib.contextmanager
def environ(**values):
    """Set environment variables for the body, then restore them."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def mesh_kernels(dev, bench_all, report):
    """Phase 10, first: the kernels of one shard of the sharded chain at
    the bench corpus's charge-2 block on [card] x 4, against their plain
    versions, bit for bit and against a second launch: the pair lists
    against the shard's halo pool (queries and pool apart, the lists of
    the shard's halo k-NN), and B.2's sums and dots alone (the sharded
    medoid scores' per-shard sums and row dots).  Returns the largest
    differences, by kernel."""
    import torch

    from falcon_tpu_torch.ops import medoids as md
    from falcon_tpu_torch.ops import pairwise as pw
    from falcon_tpu_torch.ops.vectorize import SpectrumHasher, normalize_rows
    from falcon_tpu_torch.parallel import mesh as pm
    from falcon_tpu_torch.parallel import sharded_knn as sk

    mz, intensity, pmz = bench_block(bench_all, dev)
    n, n_pad = len(pmz), mz.shape[0]
    m = pm.Mesh((dev,) * 4)
    local = n_pad // 4
    mz_s, int_s = pm.shard_rows(m, mz), pm.shard_rows(m, intensity)
    pmz_full = np.full(n_pad, np.inf, np.float32)
    pmz_full[:n] = pmz
    hasher = SpectrumHasher(101.0, 1500.0, TOL)
    vectors = [normalize_rows(hasher.vectorize(a, b, norm=False))
               for a, b in zip(mz_s, int_s)]
    block = min(1024, local)
    starts, window = sk._band_windows(pmz, 20.0, False, 4, local, block)
    _, neigh = sk.local_banded_topk(
        m, vectors, pm.shard_rows(m, torch.from_numpy(pmz_full).to(dev)),
        starts, 20.0, 128, False, block, window)
    pool_mz, pool_int = sk.halo(m, mz_s)[1], sk.halo(m, int_s)[1]
    # Shard 1's halo starts at global row (1 - 1) * local = 0, so its
    # global ids are its pool ids.
    ids = neigh[1].contiguous()
    parity = Parity()
    args = (mz_s[1], int_s[1], pool_mz, pool_int, ids, TOL, 4)
    got, again = pw.pair_list_scores(*args), pw.pair_list_scores(*args)
    want, t_plain = plain_ms(lambda: pw.pair_list_scores_plain(*args))
    what = (f"halo pool, shard 1 of 4: {local} queries x {ids.shape[1]} "
            f"slots ({int((ids >= 0).sum())} pairs) in a pool of "
            f"{pool_mz.shape[0]}")
    parity.check(PL, what, got, want, again)
    ms = kernel_ms(lambda: pw.pair_list_scores(*args), reps=10)
    valid = ids >= 0
    ii = torch.arange(local, device=dev)[:, None].expand_as(ids)[valid]
    edges = edge_counts(mz_s[1], int_s[1], ii, pool_mz, pool_int, ids[valid],
                        TOL)
    # Bytes: the queries and the pool read once, the lists read, scores
    # and match counts written.
    pl_bound = bound(ii.shape[0], int(edges.sum()),
                     (local + pool_mz.shape[0]) * 512 + ids.numel() * 16)
    log(f"  {PL} {what}: kernel {ms:.4f} ms, plain version {t_plain:.1f} "
        f"ms, bound {pl_bound[0]:.5f} ms ({pl_bound[1]})")
    out = {"pair_list_halo_ms": ms, "pair_list_halo_plain_ms": t_plain,
           "pair_list_halo_bound_ms": pl_bound[0],
           "pair_list_halo_bound_by": pl_bound[1],
           "pair_list_halo_pairs": int(ii.shape[0]),
           "pair_list_halo_edges": int(edges.sum())}
    # B.2's sums and dots on each shard, segments of 10 rows (the bench
    # corpus's cluster size), padding rows in segment 0.
    seg = torch.zeros(n_pad, dtype=torch.int32, device=dev)
    seg[:n] = torch.arange(n, device=dev, dtype=torch.int32) // 10
    n_seg = int(seg.max()) + 1
    seg_s = pm.shard_rows(m, seg)
    for d, (v, s_) in enumerate(zip(vectors, seg_s)):
        sums, sums2 = (md.segment_sums(v, s_, n_seg) for _ in range(2))
        dots, dots2 = (md.segment_dots(v, s_, sums, n_seg)
                       for _ in range(2))
        torch.cuda.synchronize()
        for name, a, b, c in (
                ("segment_sums", sums, sums2,
                 md.segment_sums_plain(v, s_, n_seg)),
                ("segment_dots", dots, dots2,
                 md.segment_dots_plain(v, s_, sums, n_seg))):
            if not (torch.equal(a, c) and torch.equal(a, b)):
                raise AssertionError(f"{B2} {name}, shard {d} of 4: not "
                                     f"bit-identical to the plain version "
                                     f"and a second launch")
    log(f"  {B2} segment_sums and segment_dots, 4 shards of {local} rows, "
        f"{n_seg} segments: bit-identical to their plain versions and to "
        f"a second launch")
    v, s1 = vectors[1], seg_s[1]
    sums = md.segment_sums(v, s1, n_seg)
    dim = v.shape[1]
    for name, fn, plain, library, n_bytes in (
            ("segment_sums", lambda: md.segment_sums(v, s1, n_seg),
             lambda: md.segment_sums_plain(v, s1, n_seg),
             lambda: torch.zeros((n_seg, dim), device=dev).index_add_(
                 0, s1.long(), v),
             (local * dim + local + n_seg * dim) * 4),
            ("segment_dots", lambda: md.segment_dots(v, s1, sums, n_seg),
             lambda: md.segment_dots_plain(v, s1, sums, n_seg),
             lambda: (v * sums[s1.long()]).sum(dim=1),
             (local * dim + 2 * local + n_seg * dim) * 4)):
        out[f"{name}_ms"] = kernel_ms(fn, reps=10)
        out[f"{name}_plain_ms"] = plain_ms(plain)[1]
        out[f"{name}_library_ms"] = kernel_ms(library, reps=10)
        out[f"{name}_bound_ms"] = n_bytes / HBM_BYTES_PER_S * 1e3
        log(f"  {B2} {name}, shard 1 ({local} rows x {dim}, {n_seg} "
            f"segments): {out[f'{name}_ms']:.4f} ms, plain version "
            f"{out[f'{name}_plain_ms']:.1f} ms, library "
            f"{out[f'{name}_library_ms']:.4f} ms, bound "
            f"{out[f'{name}_bound_ms']:.5f} ms (bytes)")
    report["mesh_kernels"] = out
    return parity.err


@contextlib.contextmanager
def recorded(module, attr):
    """Record the (args, kwargs) of each call of ``module.attr`` in the
    body, the call itself unchanged (not a kernel's wrapper: its launch
    count is read under its module name)."""
    fn = getattr(module, attr)
    calls = []

    def spy(*args, **kwargs):
        calls.append((args, kwargs))
        return fn(*args, **kwargs)

    setattr(module, attr, spy)
    try:
        yield calls
    finally:
        setattr(module, attr, fn)


def slice_kernels(dev, dense_rows, report):
    """Phase 10: K1 on each shard's condensed slice, [card] x 4.  The four
    slices of a 3,000-spectrum dense interval (row panels of 2,048, the
    first and last rows of each slice cut) against K1's plain version, bit
    for bit, with and without match counts, and against a second launch;
    then shard 1's slice of the whole dense interval timed, with its copy
    to the host and K1's calls alone, and a bound from the edges of a
    sample of its pairs.  Returns the largest difference."""
    import torch

    from falcon_tpu_torch.ops import pairwise as pw
    from falcon_tpu_torch.parallel import sharded_exact as se

    def slices(mz, intensity, d, min_matches, buf, panel_scores):
        n = mz.shape[0]
        m = n * (n - 1) // 2
        per = -(-m // 4)
        k0, k1 = d * per, min((d + 1) * per, m)
        saved, se.panel_scores = se.panel_scores, panel_scores
        try:
            se._slice_distances(mz, intensity, se.condensed_offsets(n), k0,
                                k1, TOL, min_matches, 8, PANEL_ROWS, buf)
        finally:
            se.panel_scores = saved
        return k0, k1

    mz, intensity = (torch.from_numpy(a).to(dev)
                     for a in padded(dense_rows[:3000]))
    m = 3000 * 2999 // 2
    err = 0.0
    for min_matches in (0, 6):
        for d in range(4):
            got, again, want = (np.ones(m, np.float32) for _ in range(3))
            k0, k1 = slices(mz, intensity, d, min_matches, got,
                            pw.panel_scores)
            slices(mz, intensity, d, min_matches, again, pw.panel_scores)
            slices(mz, intensity, d, min_matches, want,
                   pw.panel_scores_plain)
            err = max(err, float(np.abs(got - want).max()))
            if not (got.tobytes() == want.tobytes() == again.tobytes()):
                raise AssertionError(f"{K1} shard {d}'s condensed slice "
                                     f"(min_matches {min_matches}): not "
                                     f"bit-identical to the plain version "
                                     f"and a second launch")
    log(f"  {K1} the condensed slices of 3,000 spectra on 4 shards, "
        f"min_matches 0 and 6: bit-identical to the plain version and to a "
        f"second launch")
    mz, intensity = (torch.from_numpy(a).to(dev) for a in padded(dense_rows))
    n = mz.shape[0]
    buf = np.empty(n * (n - 1) // 2, np.float32)
    k0, k1 = slices(mz, intensity, 1, 0, buf, pw.panel_scores)

    def run():
        slices(mz, intensity, 1, 0, buf, pw.panel_scores)

    ms = kernel_ms(run, reps=3)
    offs = se.condensed_offsets(n)
    # K1's wrapper calls alone: the slice's row panels (its first and last
    # rows whole), no copy to the host.
    i0 = int(np.searchsorted(offs, k0, side="right")) - 1
    i1 = int(np.searchsorted(offs, k1 - 1, side="right"))
    k1_ms = kernel_ms(lambda: [pw.panel_scores(
        mz[r0:min(r0 + PANEL_ROWS, i1)], intensity[r0:min(r0 + PANEL_ROWS,
                                                            i1)],
        mz, intensity, r0, TOL, 8, upper_only=True, with_matches=False)
        for r0 in range(i0, i1, PANEL_ROWS)], reps=3)
    # Edges of a sample of the slice's pairs, scaled to the slice.
    ks = np.sort(np.random.default_rng(3).integers(k0, k1, 1 << 18))
    ii = np.searchsorted(offs, ks, side="right") - 1
    jj = ks - offs[ii] + ii + 1
    ii_t, jj_t = (torch.from_numpy(a).to(dev) for a in (ii, jj))
    edges = float(edge_counts(mz, intensity, ii_t, mz, intensity, jj_t,
                              TOL).double().mean()) * (k1 - k0)
    rows = i1 - i0
    # Bytes: the slice's rows and every column read once, the slice
    # written to the host.
    b_ms, b_by = bound(k1 - k0, edges, (rows + n) * 512 + (k1 - k0) * 4)
    log(f"  {K1} shard 1 of 4's condensed slice of the dense interval "
        f"({n} spectra, pairs {k0}..{k1}, {rows} rows): {ms:.3f} ms with "
        f"the copy to the host, K1's calls {k1_ms:.3f} ms; bound "
        f"{b_ms:.4f} ms ({b_by}, {edges / (k1 - k0):.3f} edges a pair from "
        f"a sample of {len(ks)})")
    report["k1_shard_slice"] = dict(
        spectra=n, pairs=k1 - k0, rows=rows, ms=ms, kernel_ms=k1_ms,
        bound_ms=b_ms, bound_by=b_by, edges_per_pair=edges / (k1 - k0))
    return err


def halo_window_kernels(dev, bench_all, report):
    """Phase 10: the exact index's pair lists on shard 1's windowed halo
    pool (the bench corpus's charge-2 block in 4 shards, [card] x 4), as
    ``parallel/sharded_exact_index.py`` launches them, against the plain
    version bit for bit and a second launch, timed, with a bound from the
    edges of its pairs.  Returns the largest difference."""
    import torch

    from falcon_tpu_torch.ops import pairwise as pw
    from falcon_tpu_torch.parallel import mesh as pm
    from falcon_tpu_torch.parallel import sharded_exact_index as sei

    rows = sorted((r for r in bench_all if r["precursor_charge"] == 2),
                  key=lambda r: r["precursor_mz"])
    mz, intensity = padded(rows)
    pmz = np.asarray([r["precursor_mz"] for r in rows])
    m = pm.Mesh((dev,) * 4)
    with recorded(sei, "rerank_exact") as calls:
        sei.exact_banded_topk_sharded(mz, intensity, pmz, 20.0, "ppm", 64,
                                      TOL, m)
    if len(calls) != 4:
        raise AssertionError(f"the sharded exact index made {len(calls)} "
                             f"reranks, not 4")
    # Shard 1's launch: its queries against its halo pool.
    (q_mz, q_int, ids, tol, _, rounds), kw = calls[1]
    pool_mz, pool_int = kw["pool"]
    args, kwargs = (q_mz, q_int, pool_mz, pool_int, ids, tol, rounds), {}
    parity = Parity()
    got, again = pw.pair_list_scores(*args, **kwargs), pw.pair_list_scores(
        *args, **kwargs)
    want, t_plain = plain_ms(lambda: pw.pair_list_scores_plain(*args,
                                                               **kwargs))
    valid = ids >= 0
    what = (f"windowed halo pool, shard 1 of 4: {q_mz.shape[0]} queries x "
            f"{ids.shape[1]} window slots ({int(valid.sum())} pairs in "
            f"band) in a pool of {pool_mz.shape[0]}")
    parity.check(PL, what, got, want, again)
    ms = kernel_ms(lambda: pw.pair_list_scores(*args, **kwargs), reps=10)
    ii = torch.arange(q_mz.shape[0], device=dev)[:, None].expand_as(
        ids)[valid]
    edges = edge_counts(q_mz, q_int, ii, pool_mz, pool_int, ids[valid], TOL)
    b_ms, b_by = bound(ii.shape[0], int(edges.sum()),
                       (q_mz.shape[0] + pool_mz.shape[0]) * 512
                       + ids.numel() * 16)
    log(f"  {PL} {what}: kernel {ms:.4f} ms, plain version {t_plain:.1f} "
        f"ms, bound {b_ms:.5f} ms ({b_by})")
    report["pair_list_window"] = dict(
        ms=ms, plain_ms=t_plain, bound_ms=b_ms, bound_by=b_by,
        pairs=int(ii.shape[0]), edges=int(edges.sum()),
        slots=int(ids.numel()))
    return parity.err.get(PL, 0.0)


def ring_kernels(dev, bench_all, report):
    """Phase 10: IVF.1 on the IVF ring's steps (the bench corpus's charge-2
    block in 4 shards, [card] x 4, the engine's k and probes): every launch
    of shard 1 at ring step 1 against the plain version bit for bit and a
    second launch, timed beside PyTorch's gather + einsum + mask + stable
    sort, with its byte bound; the ring against the ring on the plain
    versions; and the ring's device time against the one-device
    self-search's (torch.profiler).  Returns the largest difference."""
    import torch

    from falcon_tpu_torch.cluster import ann_engine
    from falcon_tpu_torch.ops import ivf
    from falcon_tpu_torch.parallel import mesh as pm
    from falcon_tpu_torch.parallel import sharded_ivf as si

    mz, intensity, pmz = bench_block(bench_all, dev)
    index, _, _, _ = ivf_index(mz, intensity, pmz, dev)
    _, k_ivf = ann_engine.ivf_widths(ann_engine.band_spans(pmz, 20.0, "ppm"),
                                     64, 128, True)
    m = pm.Mesh((dev,) * 4)

    def ring():
        return si.ivf_search_sharded(index, k_ivf, 32, 20.0, "ppm", m)

    with recorded(si, "probe_topk") as calls:
        got = ring()
    saved, si.probe_topk = si.probe_topk, ivf.probe_topk_plain
    try:
        want = ring()
    finally:
        si.probe_topk = saved
    check_bits(IVF1, "the ring of 4 shards", got, ring(), want)
    n_step = len(calls) // 16  # launches a (shard, step)
    step = calls[(1 * 4 + 1) * n_step:(1 * 4 + 2) * n_step]  # step 1, shard 1
    for args, _ in step:
        check_bits(IVF1, f"ring step 1, shard 1, lists {args[10]}+"
                   f"{args[11]} (masked probes)", ivf.probe_topk(*args),
                   ivf.probe_topk(*args), ivf.probe_topk_plain(*args))
    ms = kernel_ms(lambda: [ivf.probe_topk(*a) for a, _ in step], reps=5)
    lib_ms = kernel_ms(lambda: [probe_topk_library(*a) for a, _ in step],
                       reps=3)
    plain = plain_ms(lambda: [ivf.probe_topk_plain(*a) for a, _ in step])[1]
    # Bytes the step must move: each query slot's m/z and row, the held
    # block's slots' m/z and rows, the vectors of the query and slab slots
    # with a pair in band (bf16), the probe ids and the lists written.
    n_bytes = 0
    for args, _ in step:
        q3d, qmz, qrow, c3d, cmz, crow, probe_ids = args[:7]
        k, c0, chunk = args[9:12]
        probes = probe_ids[c0:c0 + chunk].long()
        valid = probe_mask(qmz, qrow, cmz, crow, probes, 20.0, False, c0,
                           chunk)
        lb, dim = c3d.shape[1], c3d.shape[2]
        hit = torch.zeros(c3d.shape[:2], dtype=torch.int32, device=dev)
        hit.index_put_((probes.flatten(),),
                       valid.any(1).flatten(0, 1).int(), accumulate=True)
        held = torch.unique(probes)
        n_bytes += (chunk * q3d.shape[1] * 8
                    + int((held < c3d.shape[0] - 1).sum()) * lb * 8
                    + int(valid.flatten(2).any(-1).sum()) * dim * 2
                    + int((hit > 0).sum()) * dim * 2 + probes.numel() * 4
                    + chunk * q3d.shape[1] * k * 8)
    b_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    split_ring = device_split(ring, reps=1)
    split_one = device_split(lambda: index.self_search(
        k_ivf, n_probe=32, tol_mass=20.0, tol_mode="ppm"), reps=1)
    ring_ms, one_ms = sum(split_ring.values()), sum(split_one.values())
    log(f"  {IVF1} ring step 1, shard 1 of 4 ({len(step)} launches, "
        f"{index.n_lists // 4} query lists, k = {step[0][0][9]}): "
        f"{ms:.4f} ms, plain version {plain:.1f} ms, library "
        f"{lib_ms:.4f} ms, bound {b_ms:.5f} ms (bytes)")
    log(f"  IVF ring of 4 shards, bench block: device time {ring_ms:.4f} ms "
        f"(IVF.1 {sum(v for k, v in split_ring.items() if 'ivf_' in k):.4f});"
        f" one-device self-search {one_ms:.4f} ms (torch.profiler)")
    report["ivf_ring"] = dict(
        step_ms=ms, step_plain_ms=plain, step_library_ms=lib_ms,
        step_bound_ms=b_ms, launches_a_step=len(step),
        ring_device_ms=ring_ms, self_search_device_ms=one_ms,
        ring_split=split_ring, one_split=split_one)
    return 0.0


def sharded_split(dev, bench_all, tmp, report):
    """Phase 10, last: one sharded run (the bench corpus's charge 2, dbscan
    mode, on [card] x 4) under torch.profiler, with the plain pair-list
    version made to raise; fails unless the pair-list, vectorize and B.2
    kernels ran on the card."""
    from falcon_tpu_torch.cluster import ann_engine
    from falcon_tpu_torch.ops import pairwise as pw
    from falcon_tpu_torch.store.store import SpectrumStore

    store = SpectrumStore(os.path.join(tmp, "sharded_split"))
    writer = store.writer()
    writer.add_many([r for r in bench_all if r["precursor_charge"] == 2])
    writer.close()
    dataset = store.dataset(2)

    def refuse(*args, **kwargs):
        raise AssertionError("the sharded rerank ran the plain pair-list "
                             "version")

    def run():
        return ann_engine.generate_clusters(
            dataset, EPS, 2, 0, 20.0, "ppm", None, TOL, 2**15, devices=4,
            device=dev, cluster_method="dbscan")

    saved = pw.pair_list_scores_plain
    pw.pair_list_scores_plain = refuse
    try:
        with environ(FALCON_TPU_TORCH_VIRTUAL_DEVICES=4):
            before = launch_counts()
            split = device_split(run, reps=1)
            after = launch_counts()
    finally:
        pw.pair_list_scores_plain = saved
    for k in (VEC, PL, B2):
        if after[k] <= before[k]:
            raise AssertionError(f"sharded run: {k} never launched")
    if not split:
        log("  sharded run device time: not measured (the profiler saw no "
            "device time)")
        return
    for word in ("pair_list_kernel", "vectorize_kernel",
                 "hashed_medoid_sums_kernel", "hashed_medoid_dot_kernel"):
        if not any(word in k for k in split):
            raise AssertionError(f"sharded run: no {word} in the profile")

    def total(*words):
        return sum(v for k, v in split.items() if any(w in k for w in words))

    parts = dict(device_ms=sum(split.values()),
                 pair_lists_ms=total("pair_list_kernel"),
                 vectorize_ms=total("vectorize_kernel"),
                 medoids_ms=total("hashed_medoid", "groupby_"),
                 gemm_ms=total("gemm"), sort_ms=total("Sort", "sort"),
                 segment_reduce_ms=total("SegmentedReduce"))
    parts["other_ms"] = parts["device_ms"] - sum(
        v for k, v in parts.items() if k != "device_ms")
    log("  sharded dbscan run, bench charge 2, [card] x 4, device time "
        "(torch.profiler, ms): " + ", ".join(
            f"{k[:-3]} {v:.4f}" for k, v in parts.items()))
    top = sorted(split.items(), key=lambda kv: -kv[1])[:6]
    log("  its largest kernels: " + "; ".join(
        f"{k.split('(')[0][:60]} {v:.4f} ms" for k, v in top))
    report["sharded_split"] = dict(parts, kernels=split)


def driven(fn):
    """``fn()`` with every launch count set to 0 before it; returns (its
    result, the launch counts after it)."""
    for attrs in wrappers().values():
        for module, attr in attrs:
            getattr(module, attr).launches = 0
    out = fn()
    return out, launch_counts()


def step_and_dryrun(dev, bench_all, report):
    """Phase 10, last paths: ``multichip_cluster_step`` on the bench
    corpus's charge-2 block in 4 shards of the card (the vectorize kernel,
    B.2's sums, K1's exact tile, held against K1's plain version), and the
    graft entry's ``dryrun_multichip(4)``; returns the launch counts of
    each."""
    import torch

    from falcon_tpu_torch.graft_entry import dryrun_multichip
    from falcon_tpu_torch.ops import pairwise as pw
    from falcon_tpu_torch.ops.hashing import binning_dims, hash_bin_mapping
    from falcon_tpu_torch.parallel import mesh as pm

    rows = sorted((r for r in bench_all if r["precursor_charge"] == 2),
                  key=lambda r: r["precursor_mz"])
    rows = rows[:len(rows) - len(rows) % 4]
    mz, intensity = padded(rows)
    pmz = np.asarray([r["precursor_mz"] for r in rows], np.float32)
    n_bins, min_bound, _ = binning_dims(101.0, 1500.0, TOL)
    rng = np.random.default_rng(42)
    centroids = rng.normal(size=(256, 512)).astype(np.float32)
    centroids /= np.linalg.norm(centroids, axis=1, keepdims=True)
    m = pm.Mesh((dev,) * 4)
    t0 = time.perf_counter()
    (cent, top_s, top_i, exact), counts = driven(
        lambda: pm.multichip_cluster_step(
            m, mz, intensity, pmz, hash_bin_mapping(n_bins, 400, 0),
            centroids, min_bound, TOL, n_bins))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    n = len(rows)
    local = n // 4
    # Each shard's exact tile against K1's plain version on its rows.
    mz_t, int_t = torch.from_numpy(mz).to(dev), torch.from_numpy(
        intensity).to(dev)
    want = torch.cat([pw.panel_scores_plain(
        mz_t[d * local:d * local + 8], int_t[d * local:d * local + 8], mz_t,
        int_t, 0, TOL, with_matches=False)[0] for d in range(4)])
    if not (bool(torch.isfinite(cent).all()) and top_s.shape == (n, 8)
            and top_i.shape == (n, 8) and torch.equal(exact, want)):
        raise AssertionError("multichip_cluster_step: non-finite centroids, "
                             "wrong shapes, or an exact tile that is not "
                             "K1's plain version's bits")
    for k in (VEC, B2, K1):
        if counts[k] <= 0:
            raise AssertionError(f"multichip_cluster_step: {k} never "
                                 f"launched")
    log(f"  multichip_cluster_step, bench charge-2 block ({n} spectra) in "
        f"4 shards: {seconds:.3f} s; launches {counts}")
    report["multichip_cluster_step"] = dict(spectra=n, seconds=seconds,
                                            launches=counts)
    t0 = time.perf_counter()
    _, dry = driven(lambda: dryrun_multichip(4))
    log(f"  dryrun_multichip(4) on [card] x 4: passed in "
        f"{time.perf_counter() - t0:.2f} s; launches {dry}")
    report["dryrun_multichip"] = dict(seconds=time.perf_counter() - t0,
                                      launches=dry)
    return [counts, dry]


def phase_mesh_paths(dev, bench_all, dense_rows, bench_spectra, bench_truth,
                     dense_spectra, dense_truth, tmp, report):
    """Phase 10: ``--devices N`` on N virtual shards of the card
    (``FALCON_TPU_TORCH_VIRTUAL_DEVICES``) and the block pipeline.  The
    default ann path on the bench and dense corpora at 2 and 4 shards,
    dbscan mode and ``--rerank off`` at 4 on the bench corpus, each with
    the one-device run's labels (phases 7 and 8); a second 4-shard dbscan
    run writes the same bytes.  The bench corpus in blocks of 8,192
    spectra, one after another and two deep, in turns: the same CSV bytes,
    gauges of 1 and 2.  Returns (each run's launch counts, the kernels'
    parity errors)."""
    import torch

    from falcon_tpu_torch.utils.profiling import profiler

    log("== phase 10: --devices N on virtual shards of the card, and the "
        "block pipeline")
    errs = mesh_kernels(dev, bench_all, report)
    for k, err in ((K1, slice_kernels(dev, dense_rows, report)),
                   (PL, halo_window_kernels(dev, bench_all, report)),
                   (IVF1, ring_kernels(dev, bench_all, report))):
        errs[k] = max(errs.get(k, 0.0), err)
    launches = []
    for name, spectra, truth, n_dev, flags, required, ref, floor in (
            ("mesh2_default_ann_bench_corpus", bench_spectra, bench_truth, 2,
             ANN_DEFAULT, [VEC, PL, K4], "default_ann_bench_corpus", 0.99),
            ("mesh4_default_ann_bench_corpus", bench_spectra, bench_truth, 4,
             ANN_DEFAULT, [VEC, PL, K4], "default_ann_bench_corpus", 0.99),
            ("mesh2_default_ann_dense_corpus", dense_spectra, dense_truth, 2,
             ANN_DEFAULT, [VEC, PL, K4], "default_ann_dense_corpus", 0.99),
            ("mesh4_default_ann_dense_corpus", dense_spectra, dense_truth, 4,
             ANN_DEFAULT, [VEC, PL, K4], "default_ann_dense_corpus", 0.99),
            ("mesh4_dbscan_bench_corpus", bench_spectra, bench_truth, 4,
             DBSCAN, [VEC, PL, B2], "dbscan_bench_corpus", 0.5),
            ("mesh4_rerank_off_bench_corpus", bench_spectra, bench_truth, 4,
             RERANK_OFF, [VEC, K4], "rerank_off_bench_corpus", 0.5),
            ("mesh2_exact_dense_corpus", dense_spectra, dense_truth, 2, [],
             [K1], "dense_corpus", 0.99),
            ("mesh4_exact_dense_corpus", dense_spectra, dense_truth, 4, [],
             [K1], "dense_corpus", 0.99),
            ("mesh2_ann_exact_bench_corpus", bench_spectra, bench_truth, 2,
             ANN, [PL, K4], "ann_bench_corpus", 0.99),
            ("mesh4_ann_exact_bench_corpus", bench_spectra, bench_truth, 4,
             ANN, [PL, K4], "ann_bench_corpus", 0.99),
            ("mesh2_ann_exact_dense_corpus", dense_spectra, dense_truth, 2,
             ANN, [PL], "ann_dense_corpus", 0.99),
            ("mesh4_ann_exact_dense_corpus", dense_spectra, dense_truth, 4,
             ANN, [PL], "ann_dense_corpus", 0.99),
            ("mesh2_ivf_bench_corpus", bench_spectra, bench_truth, 2, IVF,
             [VEC, IVF1, IVF2, PL, K4], "ivf_bench_corpus", 0.99),
            ("mesh4_ivf_bench_corpus", bench_spectra, bench_truth, 4, IVF,
             [VEC, IVF1, IVF2, PL, K4], "ivf_bench_corpus", 0.99),
            ("mesh2_ivf_dense_corpus", dense_spectra, dense_truth, 2, IVF,
             [VEC, IVF1, IVF2, PL], "ivf_dense_corpus", 0.99),
            ("mesh4_ivf_dense_corpus", dense_spectra, dense_truth, 4, IVF,
             [VEC, IVF1, IVF2, PL], "ivf_dense_corpus", 0.99),
            ("mesh4_ivf_rerank_off_dbscan_bench_corpus", bench_spectra,
             bench_truth, 4, IVF + ["--rerank", "off", "--cluster_method",
                                    "dbscan"],
             [VEC, IVF1, IVF2, B2], "ivf_rerank_off_dbscan_bench_corpus",
             0.5)):
        log(f"  {name}")
        with environ(FALCON_TPU_TORCH_VIRTUAL_DEVICES=n_dev):
            launches.append(phase_main_path(
                name, spectra, truth, tmp, report, required,
                flags + ["--devices", str(n_dev), "--overwrite"],
                min_completeness=0.0, min_purity=floor))
        same = report["labels"][name] == report["labels"][ref]
        if "ivf" in name:
            # The ring breaks ties in the JAX package's sharded order, so
            # the bar is its own: pair-F1 1.0 against one device.
            agreement = pair_f1(report, name, ref)
            report[f"{name}_vs_{ref}"] = agreement
            log(f"  {name}: pair F1 {agreement['f1']:.6f} against {ref}'s "
                f"labels (one device); labels "
                f"{'identical' if same else 'not identical'}")
            if agreement["f1"] != 1.0:
                raise AssertionError(f"{name}: pair F1 {agreement['f1']} "
                                     f"against {ref}'s labels, not 1.0")
            continue
        if not same:
            raise AssertionError(f"{name}: labels differ from {ref}'s (one "
                                 f"device)")
        log(f"  {name}: labels identical to {ref}'s (one device)")
    with environ(FALCON_TPU_TORCH_VIRTUAL_DEVICES=4):
        check_repeatable("mesh4_dbscan_bench_corpus", bench_spectra,
                         bench_truth, tmp, tuple(
                             DBSCAN + ["--devices", "4", "--overwrite"]))

    # Every run writes the same paths (the CSV names the input file and the
    # work_dir), each from a fresh work_dir, so each ingests; the depths
    # take turns (1, 2, 2, 1).
    runs, name = [], "blocks_default_ann_bench_corpus"
    for turn, depth in enumerate((1, 2, 2, 1)):
        log(f"  {name}, blocks of {BLOCK_CAP} spectra, {depth} in flight")
        shutil.rmtree(os.path.join(tmp, f"{name}_work"), ignore_errors=True)
        with environ(FALCON_TPU_DEVICE_BLOCK_CAP=BLOCK_CAP,
                     FALCON_TPU_BLOCK_PIPELINE=depth):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            profiler.start_recording()
            try:
                launches.append(phase_main_path(
                    name, bench_spectra, bench_truth, tmp, report,
                    [VEC, PL, K4], ANN_DEFAULT + ["--overwrite"],
                    min_completeness=0.0, min_purity=0.99))
            finally:
                profiler.stop_recording()
            peak = torch.cuda.max_memory_allocated()
        with open(os.path.join(tmp, f"{name}_out.csv"), "rb") as f:
            csv_bytes = f.read()
        run = report.pop(name)
        run.update(depth=depth,
                   gauge=profiler.counters()["ann.blocks_in_flight.max"],
                   peak_bytes=peak)
        log(f"  depth {depth}: {run['seconds']:.2f} s, block gauge "
            f"{run['gauge']}, peak device memory {peak / 2**20:.1f} MiB "
            f"(torch.cuda.max_memory_allocated)")
        report[f"{name}_turn{turn}_depth{depth}"] = run
        runs.append((csv_bytes, run))
    if any(b != runs[0][0] for b, _ in runs):
        raise AssertionError("two blocks in flight wrote other CSV bytes "
                             "than one")
    gauges = [run["gauge"] for _, run in runs]
    if gauges != [1, 2, 2, 1]:
        raise AssertionError(f"block gauges {gauges}, not [1, 2, 2, 1]")
    log(f"  blocks two deep: the serial runs' CSV bytes ({len(runs[0][0])})"
        f"; serial {runs[0][1]['seconds']:.2f} / {runs[3][1]['seconds']:.2f}"
        f" s, two deep {runs[1][1]['seconds']:.2f} / "
        f"{runs[2][1]['seconds']:.2f} s")
    sharded_split(dev, bench_all, tmp, report)
    launches.extend(step_and_dryrun(dev, bench_all, report))
    return launches, errs


def unambiguous(n: int, seed: int):
    """(mz, intensity) (n, 64) float32: 20 to 64 peaks a spectrum, each
    within 0.4 TOL of one point of a 0.5 m/z grid, no two of one spectrum
    at one point, unit norm, in no m/z order; so each peak has at most one
    partner within TOL and locally-dominant matching is optimal."""
    rng = np.random.default_rng(seed)
    mz = np.full((n, 64), -1e6, np.float32)
    intensity = np.zeros((n, 64), np.float32)
    for i in range(n):
        k = int(rng.integers(20, 65))
        points = rng.choice(100, size=k, replace=False)
        mz[i, :k] = 150.0 + 0.5 * points + rng.uniform(-0.4 * TOL,
                                                       0.4 * TOL, k)
        w = rng.uniform(0.05, 1.0, k)
        intensity[i, :k] = w / np.sqrt((w * w).sum())
    return mz, intensity


def oracle_check(dev, report):
    """Phase 11, first: K4's pair kernel against the host oracle
    (``cluster/oracle.py``, the optimal assignment) on spectra whose peaks
    each have at most one partner: scores within 1e-6, counts equal."""
    import torch

    from falcon_tpu_torch.cluster.oracle import cosine_exact
    from falcon_tpu_torch.ops import pairwise

    mz, intensity = unambiguous(96, seed=11)
    starts = torch.tensor([0, 40, 96], dtype=torch.int64, device=dev)
    scores, matches = pairwise.batched_block_scores(
        torch.from_numpy(mz).to(dev), torch.from_numpy(intensity).to(dev),
        starts, TOL)
    want_s, want_m = [], []
    for a, b in ((0, 40), (40, 96)):
        for i in range(a, b):
            for j in range(i + 1, b):
                s_ij, m_ij = cosine_exact(mz[i], intensity[i], mz[j],
                                          intensity[j], TOL)
                want_s.append(s_ij)
                want_m.append(m_ij)
    err = float(np.abs(scores.cpu().numpy() - np.asarray(want_s)).max())
    same = np.array_equal(matches.cpu().numpy(), np.asarray(want_m))
    log(f"  K4's pair kernel against the Hungarian oracle: {len(want_s)} "
        f"pairs, max |score diff| {err:.3g}, match counts "
        f"{'equal' if same else 'DIFFER'}")
    report["k4_vs_oracle"] = dict(pairs=len(want_s), max_abs_err=err,
                                  counts_equal=same)
    if err > 1e-6 or not same:
        raise AssertionError("K4's pair kernel disagrees with the host "
                             "oracle on unambiguous spectra")
    return err


def run_cli_plain(name, spectra, truth, tmp, flags):
    """``run_cli`` with every kernel wrapper replaced by its plain
    version (on the card): returns (seconds, labels by spectrum id)."""
    pairs = [pair for attrs in wrappers().values() for pair in attrs]
    saved = [getattr(m, a) for m, a in pairs]
    for module, attr in pairs:
        setattr(module, attr, getattr(module, f"{attr}_plain"))
    try:
        seconds, _, _, _, labels = run_cli(name, spectra, truth, tmp, flags)
    finally:
        for (module, attr), wrapper in zip(pairs, saved):
            setattr(module, attr, wrapper)
    return seconds, labels


def switch_run(name, env, spectra, truth, tmp, report, required, flags,
               min_purity):
    """One switch of phase 11: the CLI under ``env`` through the kernels
    (timed, its launches returned), a second time (the same CSV and MGF
    bytes) and through the plain versions (the same labels and MGF)."""
    flags = list(flags) + ["--overwrite"]
    with environ(**env):
        launches = phase_main_path(name, spectra, truth, tmp, report,
                                   required, flags, min_completeness=0.0,
                                   min_purity=min_purity)
        check_repeatable(name, spectra, truth, tmp, tuple(flags))
        seconds, labels = run_cli_plain(f"{name}_plain", spectra, truth,
                                        tmp, flags)
    same = labels == report["labels"][name]
    mgf = os.path.join(tmp, f"{name}_out.mgf")
    if os.path.isfile(mgf):
        with open(mgf, "rb") as f, open(os.path.join(
                tmp, f"{name}_plain_out.mgf"), "rb") as g:
            same = same and f.read() == g.read()
    log(f"  {name}: plain versions {seconds:.2f} s, labels"
        f"{' and MGF' if os.path.isfile(mgf) else ''} "
        f"{'identical' if same else 'DIFFER'}")
    report[name]["plain_s"] = seconds
    report[name]["identical_to_plain"] = same
    if not same:
        raise AssertionError(f"{name}: kernels and plain versions disagree")
    return launches


def phase_switches(dev, bench_spectra, bench_truth, chains, chain_truth,
                   tmp, report):
    """Phase 11: the JAX package's switches that change the result, each
    through the CLI on the bench-shaped or the chained corpus at full
    width; returns each kernel run's launch counts.  Each run is held
    against a second run (bytes) and a run on the plain versions (labels,
    MGF); spectra/s and the pair-F1 against phase 6's ann-exact labels and
    against the same mode's run without the switch (phases 7–9) are
    recorded, not asserted."""
    log("== phase 11: the JAX package's result-changing switches")
    log(f"  {card_line()}")
    oracle_check(dev, report)
    mgf = ["--export_representatives"]
    launches = []
    default, dbscan, ivf = ("default_ann_bench_corpus",
                            "dbscan_bench_corpus_mgf", "ivf_bench_corpus")
    for name, env, required, flags, min_purity, same_mode in (
            ("f32_scan_bench_corpus", dict(FALCON_TPU_KNN_DTYPE="f32"),
             [VEC, PL, K4], ANN_DEFAULT, 0.99, default),
            ("f32_scan_dbscan_bench_corpus", dict(FALCON_TPU_KNN_DTYPE="f32"),
             [VEC, PL, B1], DBSCAN + mgf, 0.5, dbscan),
            ("ivf_plain_coarse_bench_corpus",
             dict(FALCON_TPU_IVF_COARSE="plain"), [VEC, IVF1, IVF2, PL],
             IVF, 0.99, ivf),
            ("ivf_cos_rank_bench_corpus", dict(FALCON_TPU_IVF_RANK="cos"),
             [VEC, IVF1, IVF2, PL], IVF, 0.99, ivf),
            ("group_max_8_bench_corpus",
             dict(FALCON_TPU_LINKAGE_GROUP_MAX=8), [VEC, PL, K4],
             ANN_DEFAULT, 0.99, default),
            ("max_neighbors_128_bench_corpus",
             dict(FALCON_TPU_MAX_NEIGHBORS=128), [VEC, PL, K4], ANN_DEFAULT,
             0.99, default),
            ("charges_in_turn_bench_corpus",
             dict(FALCON_TPU_NO_CHARGE_OVERLAP=1), [VEC, PL, K4],
             ANN_DEFAULT, 0.99, default)):
        log(f"  {name} ({', '.join(f'{k}={v}' for k, v in env.items())})")
        launches.append(switch_run(name, env, bench_spectra, bench_truth,
                                   tmp, report, required, flags, min_purity))
        for other in ("ann_bench_corpus", same_mode):
            agreement = pair_f1(report, name, other)
            report[f"{name}_vs_{other}"] = agreement
            log(f"  pair agreement with {other}'s labels: F1 "
                f"{agreement['f1']:.6f} (recorded, not asserted)")
    if (report["labels"]["charges_in_turn_bench_corpus"]
            != report["labels"][default]):
        raise AssertionError("charges in turn gave other labels than two "
                             "at once")
    default_pl = report[default]["launches"][PL]
    log(f"  PL launches with components over 8 spectra on the pair lists: "
        f"{launches[4][PL]} (default {default_pl})")
    for linkage in ("single", "complete"):
        flags = ANN_DEFAULT + ["--linkage", linkage] + mgf
        pruned, name = (f"pruned_{linkage}_chained_corpus",
                        f"unpruned_{linkage}_chained_corpus")
        log(f"  {pruned} (the default, the reference of the next run)")
        launches.append(phase_main_path(
            pruned, chains, chain_truth, tmp, report, [VEC, PL],
            flags + ["--overwrite"], min_completeness=0.0, min_purity=0.5))
        log(f"  {name} (FALCON_TPU_LINKAGE_PRUNE=0)")
        run = switch_run(name, dict(FALCON_TPU_LINKAGE_PRUNE=0), chains,
                         chain_truth, tmp, report, [VEC, PL, K1], flags, 0.5)
        launches.append(run)
        ratios = {key: report[name][key] / report[pruned][key]
                  for key in ("seconds",)}
        ratios["ann: linkage"] = (report[name]["phases"]["ann: linkage"]
                                  / report[pruned]["phases"]["ann: linkage"])
        report[f"{name}_vs_pruned"] = ratios
        log(f"  K1 launches: {run[K1]}; {report[name]['seconds']:.2f} s "
            f"against {report[pruned]['seconds']:.2f} s pruned "
            f"({ratios['seconds']:.2f}x; ann: linkage "
            f"{ratios['ann: linkage']:.2f}x)")
    return launches


def phase_big_bucket(n_spectra, tmp, report):
    """``--big-bucket N``: one charge of ``n_spectra`` spectra (above
    2^19, the default block cap, it splits into several device blocks),
    through the CLI's default ann path with its blocks one at a time and
    two deep, in turns (1, 2, 2, 1), from a fresh work_dir each; the CSV
    bytes must not change, and each run's time, phases, block gauge and
    peak device memory are printed."""
    import torch

    from falcon_tpu_torch import cli
    from falcon_tpu_torch.simulate import make_clustered_spectra, write_mgf
    from falcon_tpu_torch.utils.profiling import profiler

    log(f"== big bucket: one charge of {n_spectra} spectra, blocks one at a "
        f"time and two deep")
    t0 = time.perf_counter()
    n_clusters = n_spectra // 20
    spectra, _ = make_clustered_spectra(
        n_clusters=n_clusters, cluster_size=10,
        n_noise=n_spectra - 10 * n_clusters, charges=(2,), seed=5)
    mgf = write_mgf(os.path.join(tmp, "big.mgf"), spectra)
    del spectra
    log(f"  corpus made and written in {time.perf_counter() - t0:.1f} s")
    out, work = os.path.join(tmp, "big_out"), os.path.join(tmp, "big_work")
    runs = []
    for turn, depth in enumerate((1, 2, 2, 1)):
        shutil.rmtree(work, ignore_errors=True)
        with environ(FALCON_TPU_BLOCK_PIPELINE=depth):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            profiler.start_recording()
            t0 = time.perf_counter()
            try:
                rc = cli.main([mgf, out, "--work_dir", work, "--backend",
                               "ann", "--overwrite"])
            finally:
                profiler.stop_recording()
            seconds = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
        if rc != 0:
            raise RuntimeError(f"big bucket: the CLI exited {rc}")
        with open(out + ".csv", "rb") as f:
            csv_bytes = f.read()
        run = dict(depth=depth, seconds=seconds,
                   spectra_per_s=n_spectra / seconds,
                   gauge=profiler.counters()["ann.blocks_in_flight.max"],
                   peak_bytes=peak,
                   phases=profiler.summary())
        log(f"  depth {depth}: {seconds:.2f} s ({n_spectra / seconds:.0f} "
            f"spectra/s, ingest included), block gauge {run['gauge']}, "
            f"peak device memory {peak / 2**30:.2f} GiB")
        log("  phases (s): " + ", ".join(f"{k} {v:.3f}" for k, v in
                                         run["phases"].items()))
        report[f"big_bucket_turn{turn}_depth{depth}"] = run
        runs.append((csv_bytes, run))
    if any(b != runs[0][0] for b, _ in runs):
        raise AssertionError("big bucket: two blocks in flight wrote other "
                             "CSV bytes than one")
    if [run["gauge"] for _, run in runs] != [1, 2, 2, 1]:
        raise AssertionError("big bucket: the blocks did not overlap two "
                             "deep (or one bucket was a single block)")
    log("  big bucket: the same CSV bytes at depth 1 and 2")


def write_report(path, report) -> None:
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(report, f, indent=1, default=str)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--report", help="also write the results as JSON")
    parser.add_argument(
        "--root", help="import falcon_tpu_torch from this checkout instead "
        "of the one beside this script (another commit, timed by the same "
        "phases)")
    parser.add_argument(
        "--kernels-only", action="store_true",
        help="stop after phase 2 (the kernels), print no result line")
    parser.add_argument(
        "--big-bucket", type=int, metavar="N",
        help="after phase 1, only time one charge of N spectra (above 2^19: "
        "several device blocks) with its blocks one at a time and two deep; "
        "print no result line")
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

    if args.big_bucket:
        with tempfile.TemporaryDirectory(prefix="falcon_chip_smoke_") as tmp:
            phase_big_bucket(args.big_bucket, tmp, report)
        write_report(args.report, report)
        return 0

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
    if args.kernels_only:
        write_report(args.report, report)
        return 0

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
        launches.extend(phase_ivf_paths(
            bench_spectra, bench_truth, dense_spectra, dense_truth, tmp,
            report))
        mesh_launches, mesh_errs = phase_mesh_paths(
            dev, bench_all, charge2, bench_spectra, bench_truth,
            dense_spectra, dense_truth, tmp, report)
        launches.extend(mesh_launches)
        for k, err in mesh_errs.items():
            errs[k] = max(errs.get(k, 0.0), err)
        launches.extend(phase_switches(
            dev, bench_spectra, bench_truth, chains, chain_truth, tmp,
            report))
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
    write_report(args.report, report)
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
