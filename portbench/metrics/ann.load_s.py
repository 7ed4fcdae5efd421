"""The ann engine's store reads (``cluster/ann_engine.py``: the charge's
precursors, retention times and peaks read from the store, and the sort by
precursor m/z), seconds a pass, summed over the charges, which run at
once: its phase ``ann: load``."""


def read(run):
    return run.mean_phase_s("ann: load")
