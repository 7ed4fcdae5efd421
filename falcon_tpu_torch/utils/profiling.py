"""Per-phase timing, a span and counter recorder, and optional device
tracing for the port.

``PhaseProfiler`` is the JAX package's (``falcon_tpu/utils/profiling.py``)
without its JAX trace hooks: the pipeline driver wraps each phase (ingest,
per-charge clustering, export) in :meth:`PhaseProfiler.phase`, and the
accumulated wall times are logged as a summary table at the end of the
run.

The port adds a recorder, off by default.  Between
:meth:`~PhaseProfiler.start_recording` and
:meth:`~PhaseProfiler.stop_recording` it keeps every phase and every
recorder-only :meth:`~PhaseProfiler.span` as a :class:`Span` (start and
end on ``time.time_ns``, thread, parent, root; a sum given to
:meth:`~PhaseProfiler.add` is a span that ends when it is added), and the
counters:
:meth:`~PhaseProfiler.count` (counts, and nanoseconds where a caller
times its own work), and the gauges of :meth:`~PhaseProfiler.gauge`
(blocks open at once) and :meth:`~PhaseProfiler.level` (a size seen).  A span's parent is the
innermost span open on its thread; work handed to another thread takes its
parent through :meth:`~PhaseProfiler.bind`.  While recording is off a span
costs one flag test besides what a phase costs, and a counter or a gauge
one flag test.

The device trace is the port's own: ``--profile DIR`` records a
``torch.profiler`` trace (CPU activity of every thread and, where present,
CUDA activity) and writes it to ``DIR/trace.json`` (Chrome / Perfetto
format) when the run ends; meanwhile each phase is also a
``torch.profiler.record_function`` range in it.
"""

import contextlib
import itertools
import logging
import os
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

logger = logging.getLogger("falcon_tpu")


class Span(NamedTuple):
    """One recorded span: times on ``time.time_ns``; ``thread`` is
    ``threading.get_ident()``; ``parent`` the id of the enclosing span
    (None for a root); ``root`` the id of the root it leads up to."""

    id: int
    name: str
    start_ns: int
    end_ns: int
    thread: int
    parent: Optional[int]
    root: int


# An open span as a thread's stack holds it, and as ``bind`` hands it to
# another thread: (span id, root id).
Frame = Tuple[int, int]

_NULL = contextlib.nullcontext()


class PhaseProfiler:
    """Accumulates named phase wall times, and records spans and counters
    while recording is on (thread-safe)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._phases: List[Tuple[str, float]] = []
        self.trace_dir: Optional[str] = None
        self._tracing = False
        self.recording = False
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._spans: List[Span] = []
        self._counters: Dict[str, int] = {}
        # name -> [level, max]; levels persist from one recording to the next
        # so that a gauge entered before a restart still leaves.
        self._gauges: Dict[str, List[int]] = {}

    def add(self, name: str, elapsed: float) -> None:
        """Add ``elapsed`` seconds to the phase ``name``; while recording,
        also a span of that length that ends now, a child of the span open
        on this thread."""
        if self.recording:
            frame, parent, _ = self._open(name)
            self._close(name, frame, parent,
                        time.time_ns() - int(elapsed * 1e9))
        with self._lock:
            self._phases.append((name, elapsed))
        logger.debug("phase %-28s %8.3f s", name, elapsed)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        opened = self._open(name) if self.recording else None
        traced = self._range(name) if self._tracing else None
        start = time.time()
        try:
            yield
        finally:
            elapsed = time.time() - start
            with self._lock:
                self._phases.append((name, elapsed))
            logger.debug("phase %-28s %8.3f s", name, elapsed)
            if traced is not None:
                traced.__exit__(None, None, None)
            if opened is not None:
                self._close(name, *opened)

    def summary(self) -> Dict[str, float]:
        """Aggregated seconds per phase name, in first-seen order."""
        out: Dict[str, float] = {}
        with self._lock:
            for name, elapsed in self._phases:
                out[name] = out.get(name, 0.0) + elapsed
        return out

    def log_summary(self) -> None:
        summary = self.summary()
        if not summary:
            return
        total = sum(summary.values())
        logger.info("Phase timing summary:")
        for name, elapsed in summary.items():
            logger.info(
                "  %-28s %8.3f s  (%4.1f%%)",
                name, elapsed, 100.0 * elapsed / total if total else 0.0,
            )
        logger.info("  %-28s %8.3f s", "total (tracked)", total)

    def reset(self) -> None:
        with self._lock:
            self._phases.clear()

    # -- the recorder ------------------------------------------------------

    def start_recording(self) -> None:
        """Drop what was recorded and record from now on."""
        with self._lock:
            self._spans.clear()
            self._counters.clear()
            for gauge in self._gauges.values():
                gauge[1] = gauge[0]
            self.recording = True

    def stop_recording(self) -> None:
        """Stop recording; what was recorded stays readable."""
        self.recording = False

    def spans(self) -> List[Span]:
        """The spans closed while recording, in the order they closed."""
        with self._lock:
            return list(self._spans)

    def counters(self) -> Dict[str, int]:
        """Counts and accumulators (nanoseconds) of the recording, and
        each gauge's highest level as ``<name>.max``."""
        with self._lock:
            out = dict(self._counters)
            out.update((name + ".max", g[1])
                       for name, g in self._gauges.items())
            return out

    def span(self, name: str, root: bool = False):
        """A recorder-only span (not a phase of the summary); ``root``
        makes it a root whatever is open on this thread."""
        if not self.recording:
            return _NULL
        return self._span(name, root)

    @contextlib.contextmanager
    def _span(self, name: str, root: bool) -> Iterator[None]:
        opened = self._open(name, root)
        try:
            yield
        finally:
            self._close(name, *opened)

    def bind(self, fn):
        """``fn``, to run on another thread with the span open here (on the
        calling thread) as the parent of the spans it opens."""
        if not self.recording:
            return fn
        stack = self._stack()
        if not stack:
            return fn
        parent = stack[-1]

        def bound(*args, **kwargs):
            stack = self._stack()
            stack.append(parent)
            try:
                return fn(*args, **kwargs)
            finally:
                stack.pop()
        return bound

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to the counter ``name``."""
        if self.recording:
            self._bump(name, n)

    def gauge(self, name: str):
        """Count the ``with`` block as one level of the gauge ``name`` for
        its duration; the recording keeps the highest level."""
        if not self.recording:
            return _NULL
        return self._gauged(name)

    @contextlib.contextmanager
    def _gauged(self, name: str) -> Iterator[None]:
        with self._lock:
            g = self._gauges.setdefault(name, [0, 0])
            g[0] += 1
            g[1] = max(g[1], g[0])
        try:
            yield
        finally:
            with self._lock:
                g[0] -= 1

    def level(self, name: str, value: int) -> None:
        """Raise the highest level the recording keeps for the gauge
        ``name`` to ``value``: a size seen (a list's length), where
        :meth:`gauge` counts blocks open at once."""
        if self.recording:
            with self._lock:
                g = self._gauges.setdefault(name, [0, 0])
                g[1] = max(g[1], value)

    def _bump(self, name: str, n: int) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def _stack(self) -> List[Frame]:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _open(self, name: str, root: bool = False):
        stack = self._stack()
        parent = None if root or not stack else stack[-1]
        span_id = next(self._ids)
        frame = (span_id, span_id if parent is None else parent[1])
        stack.append(frame)
        return frame, parent, time.time_ns()

    def _close(self, name: str, frame: Frame, parent: Optional[Frame],
               start_ns: int) -> None:
        end_ns = time.time_ns()
        self._stack().pop()
        span = Span(frame[0], name, start_ns, end_ns, threading.get_ident(),
                    None if parent is None else parent[0], frame[1])
        with self._lock:
            if self.recording:
                self._spans.append(span)

    def _range(self, name: str):
        """An open range of the device trace named ``name``, or None."""
        return None


class TorchPhaseProfiler(PhaseProfiler):
    """``PhaseProfiler`` whose trace is a ``torch.profiler`` trace."""

    def __init__(self) -> None:
        super().__init__()
        self._prof = None

    def start_trace(self, trace_dir: str) -> None:
        """Begin a torch.profiler trace into ``trace_dir`` (best effort:
        a failure to trace is logged and the run goes on)."""
        import torch

        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        try:
            prof = _profile_all_threads(torch, activities)
            prof.__enter__()
        except RuntimeError as e:  # pragma: no cover - backend dependent
            logger.warning("Could not start device trace: %s", e)
            return
        self._prof = prof
        self.trace_dir = trace_dir
        self._tracing = True

    def stop_trace(self) -> None:
        if not self._tracing:
            return
        self._tracing = False
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        os.makedirs(self.trace_dir, exist_ok=True)
        path = os.path.join(self.trace_dir, "trace.json")
        prof.export_chrome_trace(path)
        logger.info("Device trace written to %s", path)

    def _range(self, name: str):
        import torch

        rng = torch.profiler.record_function(name)
        rng.__enter__()
        return rng


def _profile_all_threads(torch, activities):
    """A ``torch.profiler.profile`` that records the CPU activity of every
    thread (the charge, block and export pools run phases), where this
    PyTorch offers it; else of the calling thread."""
    try:
        config = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except (AttributeError, TypeError):  # pragma: no cover - older torch
        return torch.profiler.profile(activities=activities)
    return torch.profiler.profile(activities=activities,
                                  experimental_config=config)


profiler = TorchPhaseProfiler()
