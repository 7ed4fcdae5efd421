"""The ann engine's component set-up before its linkage
(``cluster/ann_engine.py``: the eps-components sorted, sliced and capped
at ``batch_size``, and their members' peaks padded), seconds a pass,
summed over the charges, which run at once: its phase
``ann: components``."""


def read(run):
    return run.mean_phase_s("ann: components")
