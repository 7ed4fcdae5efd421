"""Share of the traced window in which no kernel, copy or set ran on the
card (``torch.profiler``, CUDA activity)."""


def read(run):
    if run.device is None or run.device.window_s <= 0:
        return None
    return 1.0 - run.device.busy_s / run.device.window_s
