"""The matching kernels' share of their byte bound, in percent: the bytes
the window's matching launches must move (``peaks.py``, counted by
``tracing.LaunchBytes`` around the launchers of ``ops/pairwise.py``) at
the card's memory bandwidth, over the device time of those kernels in the
trace (``csrc/pairwise.cu``: K1, K4's sort and pair kernels, the pair
lists)."""

from portbench import peaks, tracing


def read(run):
    if run.device is None or not run.match_launches:
        return None
    seconds = run.device.kernel_s(tracing.MATCH_KERNELS)
    if seconds <= 0:
        return None
    return 100.0 * run.match_bytes / peaks.HBM_BYTES_PER_S / seconds
