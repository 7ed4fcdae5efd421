"""Per-phase timing and optional device tracing for the port.

The phase bookkeeping is the JAX package's ``PhaseProfiler`` unchanged;
only the device trace differs: ``--profile DIR`` records a
``torch.profiler`` trace (CPU and, where present, CUDA activity) and writes
it to ``DIR/trace.json`` (Chrome / Perfetto format) when the run ends.
"""

import logging
import os

from falcon_tpu.utils.profiling import PhaseProfiler

logger = logging.getLogger("falcon_tpu")


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
