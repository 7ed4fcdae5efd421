"""falcon_tpu_torch: the PyTorch/CUDA port of falcon-tpu.

A second package beside the JAX reference ``falcon_tpu``, with the same CLI
(``python -m falcon_tpu_torch``), library API and output bytes, running its
hot path as CUDA kernels written for NVIDIA Hopper (``csrc/``).  It imports
``torch`` and never ``jax``; the JAX-free host modules of ``falcon_tpu``
(configuration, store, ingest, readers, preprocessing, native linkage,
export) are shared, not copied.

Ported so far: the default exact backend (``cluster/engine.py``).  See
``README.md`` for what still raises.
"""

from falcon_tpu import __version__  # noqa: F401


def cluster_files(*args, **kwargs):
    """Public API entry point; see :func:`falcon_tpu_torch.api.cluster`.
    Imported lazily so ``import falcon_tpu_torch`` stays light."""
    from .api import cluster as _cluster

    return _cluster(*args, **kwargs)
