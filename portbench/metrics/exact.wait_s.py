"""The exact engine's wait for the device's scores (``cluster/engine.py``),
seconds a pass: the sum it keeps as ``wait for scores``."""


def read(run):
    return run.mean_phase_s("wait for scores")
