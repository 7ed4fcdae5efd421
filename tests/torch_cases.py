"""Spectra that make the port's matching kernels work hard, for the
``tests/test_torch_*.py`` files: made with numpy from a seed, (n, 64)
float32 m/z and intensity with padding m/z -1e6 and intensity 0."""

import numpy as np

PAD_MZ = -1e6


def tie_heavy(n: int, seed: int):
    """(mz, intensity) (2 n, 64): peaks crowded into a few tolerance windows
    with quantised intensities, in no m/z order, each spectrum twice
    (duplicates tie everywhere)."""
    rng = np.random.default_rng(seed)
    mz = np.full((n, 64), PAD_MZ, np.float32)
    intensity = np.zeros((n, 64), np.float32)
    for i in range(n):
        k = int(rng.integers(4, 64))
        mz[i, :k] = (rng.choice([200.0, 200.03, 350.0, 500.0], size=k)
                     + rng.choice([0.0, 0.01, 0.02], size=k))
        intensity[i, :k] = rng.choice([0.25, 0.5], size=k)
    return np.repeat(mz, 2, axis=0), np.repeat(intensity, 2, axis=0)


def permuted(mz: np.ndarray, intensity: np.ndarray, seed: int):
    """Each spectrum's 64 peaks, padding included, in a random order."""
    perm = np.argsort(np.random.default_rng(seed).random(mz.shape), axis=1)
    return (np.take_along_axis(mz, perm, 1),
            np.take_along_axis(intensity, perm, 1))
