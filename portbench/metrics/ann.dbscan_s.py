"""The ann engine's DBSCAN on the exact lists (``ops/density.py``: the core
test, min-label propagation over the core-core eps-graph, border
attachment, and the compact parts read to the host and numbered), seconds
a pass, summed over the charges: its phase ``ann: dbscan``."""


def read(run):
    return run.mean_phase_s("ann: dbscan")
