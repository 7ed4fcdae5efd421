"""DBSCAN mode's refinement (``cluster/ann_engine.py::_refine_and_medoids``:
each cluster kept whole, demoted, or split by ``postprocess_cluster``
where its precursors span more than the tolerance), seconds a pass,
summed over the charges: its phase ``ann: refine``."""


def read(run):
    return run.mean_phase_s("ann: refine")
