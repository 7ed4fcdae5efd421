"""Device seconds a pass of the IVF kernels (``csrc/ivf.cu``: the probe
scan's append and rank kernels, IVF.1, and the k-means update's count,
fill and centroid kernels, IVF.2) in the trace, matched by name as
``tracing.MATCH_KERNELS`` matches the matching kernels."""

import re

IVF_KERNELS = re.compile(
    r"^(void )?(falcon::)?"
    r"(ivf_probe_append_kernel|ivf_rank_kernel|kmeans_count_kernel"
    r"|kmeans_fill_kernel|kmeans_centroids_kernel)\b")


def read(run):
    if run.device is None or not run.passes:
        return None
    seconds = run.device.kernel_s(IVF_KERNELS)
    if seconds <= 0:
        return None
    return seconds / run.passes
