"""The exact engine's host work (``cluster/engine.py``: native linkage,
cut and refinement of each precursor interval), seconds a pass: the sum it
keeps as ``linkage and refinement``."""


def read(run):
    return run.mean_phase_s("linkage and refinement")
