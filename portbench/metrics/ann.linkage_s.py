"""The ann engine's linkage (``cluster/ann_engine.py``: the exact scores
of each eps-component, the native linkage and the cut, component by
component), seconds a pass, summed over the charges, which run at once:
its phase ``ann: linkage``."""


def read(run):
    return run.mean_phase_s("ann: linkage")
