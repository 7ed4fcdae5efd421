"""The ann engine's device chain (``cluster/ann_engine.py``: upload,
hashed vectors, the bound scan, the exact rerank and the eps-components),
seconds a pass, each phase synchronised on its stream, summed over the
charges."""

PHASES = ("ann: upload", "ann: vectorize", "ann: knn", "ann: rerank",
          "ann: dbscan")


def read(run):
    return run.mean_phase_s(*PHASES)
