"""What a run records around the program, and the reading of its trace.

- ``PhaseLog`` wraps the program's phase log (``PhaseProfiler.phase`` and
  ``add`` of ``falcon_tpu_torch.utils.profiling.profiler``) at run time, so
  that every phase is kept with its start and end on the host clock and
  the pass it belongs to; the program's files are not edited.
- ``LaunchBytes`` wraps the matching launchers of ``ops/pairwise.py`` (K1
  panels, K4 grouped scores, pair lists) and counts each launch's bytes
  with ``peaks.py``.
- ``DeviceTrace`` reads a ``torch.profiler`` trace of the card's activity:
  the busy time (kernels, copies and sets, in union), the device time of
  named kernels, and the idle gaps named by the program phase open then.
- ``TracedRun`` is what a per-layer metric reader (``metrics/<name>.py``)
  is given.
"""

import contextlib
import inspect
import re
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import peaks

# The matching kernels of csrc/pairwise.cu (K4 is its sort pre-pass and
# its pair kernel).
MATCH_KERNELS = re.compile(
    r"^(void )?(falcon::)?"
    r"(panel_kernel|sort_kernel|grouped_kernel|pair_list_kernel)\b")
# The marker the harness launches to align the trace with the host clock.
MARKER_KERNEL = re.compile(r"spin_kernel")


class PhaseLog:
    """Spans (pass, name, start_ns, end_ns) of the program's phases, on
    ``time.time_ns``.  Phases kept as sums (``add``) become spans that end
    when they are added."""

    def __init__(self, profiler) -> None:
        self.profiler = profiler
        self.spans: List[Tuple[int, str, int, int]] = []
        self.pass_index = -1

    def install(self) -> None:
        orig_phase, orig_add = self.profiler.phase, self.profiler.add
        log = self

        @contextlib.contextmanager
        def phase(name):
            start = time.time_ns()
            try:
                with orig_phase(name):
                    yield
            finally:
                log.spans.append((log.pass_index, name, start,
                                  time.time_ns()))

        def add(name, elapsed):
            end = time.time_ns()
            orig_add(name, elapsed)
            log.spans.append((log.pass_index, name,
                              end - int(elapsed * 1e9), end))

        self.profiler.phase, self.profiler.add = phase, add

    def uninstall(self) -> None:
        for attr in ("phase", "add"):
            self.profiler.__dict__.pop(attr, None)


class LaunchBytes:
    """Byte bounds of the matching launches made while installed."""

    LAUNCHERS = ("batched_block_scores", "pair_list_scores", "panel_scores")

    def __init__(self, pairwise) -> None:
        self.pairwise = pairwise
        self._orig: Dict[str, object] = {}
        self._records: list = []
        self._lock = threading.Lock()

    def install(self) -> None:
        for name in self.LAUNCHERS:
            orig = getattr(self.pairwise, name)
            self._orig[name] = orig
            setattr(self.pairwise, name, self._wrap(name, orig))

    def uninstall(self) -> None:
        for name, orig in self._orig.items():
            setattr(self.pairwise, name, orig)
        self._orig.clear()

    def _wrap(self, name, orig):
        sig = inspect.signature(orig)
        counter = getattr(self, "_" + name)

        def launcher(*args, **kwargs):
            out = orig(*args, **kwargs)
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            record = counter(bound.arguments, out)
            with self._lock:
                self._records.append(record)
            return out

        # The launchers count themselves through their module's name.
        launcher.launches = getattr(orig, "launches", 0)
        return launcher

    @staticmethod
    def _batched_block_scores(a, out):
        mz = a["mz"]
        return peaks.grouped_bytes(mz.shape[0], mz.shape[1],
                                   a["starts"].shape[0] - 1, out[0].numel(),
                                   out[1] is not None)

    @staticmethod
    def _pair_list_scores(a, out):
        import torch

        ids, mz_q, mz_pool = a["ids"], a["mz_q"], a["mz_pool"]
        n_pool = mz_pool.shape[0]
        valid = ids >= 0
        # Empty slots mark a spare last row, so that nothing waits for
        # the card: the count stays there until ``total`` reads it.
        used = torch.zeros(n_pool + 1, dtype=torch.bool, device=ids.device)
        used.index_fill_(0, torch.where(valid, ids, n_pool).reshape(-1)
                         .long(), True)
        used = used[:n_pool]
        queried = valid.any(1)
        if (mz_q.data_ptr() == mz_pool.data_ptr()
                and mz_q.shape[0] <= mz_pool.shape[0]):
            # The queries are the pool's first rows: count each row once.
            used[:mz_q.shape[0]] |= queried
            read = used.sum()
        else:
            read = used.sum() + queried.sum()
        k = ids.shape[1]
        fixed = peaks.pair_list_bytes(0, mz_q.shape[1], ids.shape[0], k,
                                      out[1] is not None)
        per_spectrum = mz_q.shape[1] * peaks.SPECTRUM_BYTES_PER_PEAK
        return (read, per_spectrum, fixed)

    @staticmethod
    def _panel_scores(a, out):
        rows, cols = a["mz_rows"], a["mz_cols"]
        n_rows, n_cols = rows.shape[0], cols.shape[0]
        col_lo = cols.data_ptr()
        col_hi = col_lo + cols.numel() * cols.element_size()
        inside = col_lo <= rows.data_ptr() < col_hi
        n_read = n_cols if inside else n_rows + n_cols
        if a["upper_only"]:
            first = a["row_offset"] + 1
            per_row = np.clip(n_cols - (first + np.arange(n_rows)), 0, None)
            n_pairs = int(per_row.sum())
        else:
            n_pairs = n_rows * n_cols
        return peaks.panel_bytes(n_read, rows.shape[1], n_pairs,
                                 out[1] is not None)

    def total(self) -> int:
        """All launches' bytes (reads the counts kept on the device)."""
        total = 0
        for r in self._records:
            if isinstance(r, tuple):
                read, per_spectrum, fixed = r
                total += int(read) * per_spectrum + fixed
            else:
                total += r
        return total

    @property
    def count(self) -> int:
        return len(self._records)


def _union(intervals: np.ndarray) -> np.ndarray:
    """Disjoint sorted (start, end) rows covering ``intervals``."""
    if len(intervals) == 0:
        return intervals.reshape(0, 2)
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.r_[True, iv[1:, 0] > ends[:-1]]
    starts = iv[new, 0]
    last = np.r_[np.flatnonzero(new)[1:] - 1, len(iv) - 1]
    return np.stack([starts, ends[last]], axis=1)


@dataclass
class DeviceTrace:
    """Device activity of a traced window, on the host clock (ns)."""

    names: List[str]
    intervals: np.ndarray  # (n, 2) int64 start, end
    window: Tuple[int, int]

    @classmethod
    def from_profiler(cls, prof, marker_host_ns: Optional[int],
                      window: Tuple[int, int]) -> "DeviceTrace":
        """The CUDA events of a stopped ``torch.profiler.profile``,
        shifted onto the host clock by the marker kernel launched at
        ``marker_host_ns`` (no shift where it is missing), clipped to the
        window."""
        from torch.autograd import DeviceType

        names, rows, marker = [], [], None
        for e in prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            name = e.name()
            start = e.start_ns()
            if MARKER_KERNEL.search(name):
                if marker is None:
                    marker = start
                continue
            names.append(name)
            rows.append((start, start + e.duration_ns()))
        shift = (0 if marker is None or marker_host_ns is None
                 else marker_host_ns - marker)
        iv = np.asarray(rows, np.int64).reshape(-1, 2) + shift
        lo, hi = window
        inside = (iv[:, 1] > lo) & (iv[:, 0] < hi)
        iv = np.clip(iv[inside], lo, hi)
        names = [n for n, k in zip(names, inside) if k]
        return cls(names, iv, window)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    @property
    def busy_s(self) -> float:
        u = _union(self.intervals)
        return float((u[:, 1] - u[:, 0]).sum()) / 1e9

    def kernel_s(self, pattern: re.Pattern) -> float:
        """Device seconds of the activities whose name matches."""
        sel = np.fromiter((bool(pattern.search(n)) for n in self.names),
                          bool, len(self.names))
        iv = self.intervals[sel]
        return float((iv[:, 1] - iv[:, 0]).sum()) / 1e9

    def top_ops(self, n: int = 10) -> List[List]:
        """The ``n`` device operations that took most time: [name,
        seconds]."""
        total: Dict[str, int] = {}
        for name, (a, b) in zip(self.names, self.intervals.tolist()):
            total[name] = total.get(name, 0) + (b - a)
        ranked = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:120], t / 1e9] for name, t in ranked]

    def idle_by_phase(self, spans: Sequence[Tuple[int, str, int, int]],
                      n: int = 10) -> List[List]:
        """Idle device time by the program phase open meanwhile (the latest
        started of those open, so the innermost; time outside every phase
        is the harness's own or the CLI's outside its phases): the ``n``
        largest, [name, seconds]."""
        lo, hi = self.window
        u = _union(self.intervals)
        edges = np.r_[lo, u.ravel(), hi].reshape(-1, 2)
        gaps = edges[edges[:, 1] > edges[:, 0]]
        if not len(gaps):
            return []
        bounds = [t for _, _, a, b in spans for t in (a, b)]
        cuts = np.unique(np.clip(np.r_[gaps.ravel(), bounds].astype(
            np.int64), lo, hi))
        seg_lo, seg_hi = cuts[:-1], cuts[1:]
        mid = seg_lo + (seg_hi - seg_lo) // 2
        gap = np.searchsorted(gaps[:, 0], mid, side="right") - 1
        idle = (gap >= 0) & (mid < gaps[np.maximum(gap, 0), 1])
        owner = np.full(len(mid), -1)
        for i in sorted(range(len(spans)), key=lambda i: spans[i][2]):
            a, b = spans[i][2], spans[i][3]
            owner[np.searchsorted(mid, a):np.searchsorted(mid, b)] = i
        total: Dict[str, int] = {}
        for o, d in zip(owner[idle].tolist(),
                        (seg_hi - seg_lo)[idle].tolist()):
            name = spans[o][1] if o >= 0 else "(outside the program's phases)"
            total[name] = total.get(name, 0) + d
        ranked = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name, t / 1e9] for name, t in ranked]


@dataclass
class TracedRun:
    """What a per-layer metric reader gets from a ``--trace 1`` run."""

    passes: int
    spans: List[Tuple[int, str, int, int]]
    device: Optional[DeviceTrace] = None
    match_bytes: int = 0
    match_launches: int = 0
    # Spectra of all the window's passes, and the window's seconds on the
    # host clock (its start to the end of its last pass).
    spectra: int = 0
    window_s: float = 0.0

    def mean_phase_s(self, *names: str) -> Optional[float]:
        """Seconds of the named phases a pass, summed over the window's
        passes and divided by their count; None where none ran."""
        durations = [b - a for _, name, a, b in self.spans if name in names]
        if not durations or not self.passes:
            return None
        return sum(durations) / 1e9 / self.passes
