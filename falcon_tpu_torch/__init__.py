"""falcon_tpu_torch: the PyTorch/CUDA port of falcon-tpu.

A second package beside the JAX reference ``falcon_tpu``, with the same CLI
(``python -m falcon_tpu_torch``), library API and output bytes, running its
hot path as CUDA kernels written for NVIDIA Hopper (``csrc/``).  It imports
``torch`` and never ``jax``, and nothing of ``falcon_tpu``: the host modules
it needs (configuration, store, ingest, readers, preprocessing, the native
linkage library and its C++ sources, export) are its own copies, at the
same relative paths, held against the originals by
``tests/test_torch_host_copies.py``.

Ported so far: the default exact backend (``cluster/engine.py``), and
``--backend ann`` with its default index (the hashed upper-bound scan and
the exact rerank) or ``--ann_index exact`` (``cluster/ann_engine.py``).
See ``README.md`` for what still raises.
"""

__version__ = "0.1.0"


def cluster_files(*args, **kwargs):
    """Public API entry point; see :func:`falcon_tpu_torch.api.cluster`.
    Imported lazily so ``import falcon_tpu_torch`` stays light."""
    from .api import cluster as _cluster

    return _cluster(*args, **kwargs)
