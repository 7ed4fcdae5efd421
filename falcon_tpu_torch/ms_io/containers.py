"""Lightweight MS/MS spectrum container.

First-party replacement for ``spectrum_utils.spectrum.MsmsSpectrum`` as used
by the reference readers (``falcon/ms_io/*_io.py``) and preprocessing
(``falcon/cluster/spectrum.py:73-169``).  Only the fields and behaviors the
pipeline relies on are kept; peaks are always stored sorted by m/z as
float32 arrays.
"""

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class Spectrum:
    identifier: str
    precursor_mz: float
    precursor_charge: Optional[int]
    mz: np.ndarray
    intensity: np.ndarray
    retention_time: float = -1.0
    filename: Optional[str] = None
    # Optional export metadata (cf. reference mgf_io.py:105-110).
    scan: Optional[str] = field(default=None, repr=False)
    cluster: Optional[int] = field(default=None, repr=False)

    def __post_init__(self):
        mz = np.asarray(self.mz, dtype=np.float32)
        intensity = np.asarray(self.intensity, dtype=np.float32)
        if mz.shape != intensity.shape:
            raise ValueError("m/z and intensity arrays must match in length")
        # Guarantee peaks sorted by m/z (MsmsSpectrum does the same).
        if mz.size > 1 and np.any(np.diff(mz) < 0):
            order = np.argsort(mz, kind="stable")
            mz, intensity = mz[order], intensity[order]
        self.mz, self.intensity = mz, intensity
