"""Deterministic seeding.

Mirrors the reference's behavior of seeding ``random`` and ``numpy`` with 42
at driver import time (reference ``falcon/seed.py:6-8``, call site
``falcon/falcon.py:30``).  Additionally returns a ``jax.random`` key so the
TPU k-means / IVF path is reproducible as well (the reference's live
pipeline is deterministic; the published IVF algorithm introduces k-means
randomness that we must seed, cf. SURVEY.md §4).
"""

import random

import numpy as np

DEFAULT_SEED = 42


def set_seeds(my_seed: int = DEFAULT_SEED) -> int:
    """Seed ``random`` and ``numpy`` and return the seed for JAX PRNG keys."""
    random.seed(my_seed)
    np.random.seed(my_seed)
    return my_seed
