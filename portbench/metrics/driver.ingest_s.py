"""The driver's ingest (``cli.py``: MGF parsed and preprocessed into the
store), seconds a pass: its phase ``ingest``."""


def read(run):
    return run.mean_phase_s("ingest")
