"""The IVF index's search (``ops/ivf.py::IVFIndex`` and
``cluster/ann_engine.py::_ivf_lists``: the rows' best lists, the balanced
placement, the slab layout and its upload; the chunked probe scan and the
row mapping; the ``k_ann`` cut and the RT filter), seconds a pass, summed
over the charges: its phases ``ivf: place``, ``ivf: probe`` and ``ivf:
cut``."""

PHASES = ("ivf: place", "ivf: probe", "ivf: cut")


def read(run):
    return run.mean_phase_s(*PHASES)
