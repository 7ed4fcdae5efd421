"""The driver's export (``cli.py``: labels to CSV), seconds a pass: its
phase ``export``."""


def read(run):
    return run.mean_phase_s("export")
