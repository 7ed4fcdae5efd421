"""Per-phase timing and optional device tracing for the port.

``PhaseProfiler`` is the JAX package's (``falcon_tpu/utils/profiling.py``)
without its JAX trace hooks: the pipeline driver wraps each phase (ingest,
per-charge clustering, export) in :meth:`PhaseProfiler.phase`, and the
accumulated wall times are logged as a summary table at the end of the
run.  The device trace is the port's own: ``--profile DIR`` records a
``torch.profiler`` trace (CPU and, where present, CUDA activity) and writes
it to ``DIR/trace.json`` (Chrome / Perfetto format) when the run ends.
"""

import contextlib
import logging
import os
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

logger = logging.getLogger("falcon_tpu")


class PhaseProfiler:
    """Accumulates named phase wall times (thread-safe)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._phases: List[Tuple[str, float]] = []
        self.trace_dir: Optional[str] = None
        self._tracing = False

    def add(self, name: str, elapsed: float) -> None:
        with self._lock:
            self._phases.append((name, elapsed))
        logger.debug("phase %-28s %8.3f s", name, elapsed)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        start = time.time()
        try:
            yield
        finally:
            elapsed = time.time() - start
            with self._lock:
                self._phases.append((name, elapsed))
            logger.debug("phase %-28s %8.3f s", name, elapsed)

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
            prof = torch.profiler.profile(activities=activities)
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


profiler = TorchPhaseProfiler()
