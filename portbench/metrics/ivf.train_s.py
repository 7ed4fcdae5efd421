"""The IVF index's training (``ops/ivf.py::IVFIndex``: the training
sample, the initial centroids and the spherical k-means steps), seconds a
pass, summed over the charges: its phase ``ivf: train``."""


def read(run):
    return run.mean_phase_s("ivf: train")
