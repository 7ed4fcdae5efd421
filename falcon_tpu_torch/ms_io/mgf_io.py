"""MGF reading and writing.

First-party text parser replacing ``pyteomics.mgf`` as used by the reference
(``falcon/ms_io/mgf_io.py``).  Behavioral parity:

- required params: TITLE (identifier) and PEPMASS (first token as precursor
  m/z); spectra missing either are skipped silently
  (reference ``mgf_io.py:27-30, 46-53``).
- optional CHARGE ("2+" / "2-" / "2"); absent -> ``None``
  (reference ``mgf_io.py:54-58``).
- optional RTINSECONDS; absent -> ``-1`` (reference ``mgf_io.py:51``).
- comment lines starting with ``#``, ``;``, ``!`` or ``/`` are ignored
  and file-header parameters before the first BEGIN IONS merge into
  every spectrum with local keys taking precedence — pyteomics
  ``MGFBase._comments`` / ``use_header=True`` defaults the reference
  inherits via ``pyteomics.mgf.MGF(source)`` (reference
  ``mgf_io.py:25``).
- writer emits TITLE/PEPMASS/CHARGE and RTINSECONDS/SCAN/CLUSTER when
  present (reference ``mgf_io.py:85-116``).  Unlike the reference, a
  ``None`` precursor charge is handled by omitting CHARGE instead of
  raising ``TypeError`` (documented divergence, SURVEY.md §3.5).
"""

import logging
from typing import IO, Iterable, Iterator, List, Union

import numpy as np

from .containers import Spectrum

logger = logging.getLogger("falcon_tpu")


def _parse_charge(value: str) -> int:
    value = value.split()[0].rstrip(",")
    if value.endswith("+"):
        return int(value[:-1])
    if value.endswith("-"):
        return -int(value[:-1])
    return int(value)


def get_spectra(source: Union[IO, str]) -> Iterator[Spectrum]:
    """Iterate over the MS/MS spectra in an MGF file.

    Files are decoded as UTF-8 with undecodable bytes replaced (U+FFFD)
    rather than raised: a corrupt or binary file then parses to zero
    (or fewer) spectra through the normal malformed-spectrum skip path
    instead of aborting a whole multi-file run with a
    ``UnicodeDecodeError`` (divergence from pyteomics' strict text
    decode; tests/test_fuzz.py).
    """
    if isinstance(source, str):
        with open(source, encoding="utf-8", errors="replace") as f_in:
            yield from _iter_mgf(f_in)
    else:
        yield from _iter_mgf(source)


def _iter_mgf(f_in: IO) -> Iterator[Spectrum]:
    in_ions = False
    malformed = False
    seen_block = False
    header: dict = {}
    params, mz, intensity = {}, [], []
    for raw in f_in:
        line = raw.strip()
        if not line or line[0] in "#;!/":
            # Comment lines (pyteomics ``MGFBase._comments``).
            continue
        upper = line.upper()
        if upper.startswith("BEGIN IONS"):
            in_ions, params, mz, intensity = True, dict(header), [], []
            malformed = False
            seen_block = True
        elif upper.startswith("END IONS"):
            if in_ions and not malformed:
                spec = _make_spectrum(params, mz, intensity)
                if spec is not None:
                    yield spec
            in_ions = False
        elif in_ions:
            if "=" in line and not line[0].isdigit() and line[0] != "-":
                key, _, value = line.partition("=")
                params[key.strip().upper()] = value.strip()
            else:
                tokens = line.split()
                if len(tokens) >= 2:
                    try:
                        m, i = float(tokens[0]), float(tokens[1])
                    except ValueError:
                        # An unparseable peak line invalidates the whole
                        # spectrum, like pyteomics raising inside the
                        # reference's parse loop (skipped silently,
                        # reference mgf_io.py:27-30).
                        malformed = True
                    else:
                        mz.append(m)
                        intensity.append(i)
        elif not seen_block and "=" in line and not line[0].isdigit() \
                and line[0] != "-":
            # File-header parameter (before the first BEGIN IONS):
            # merged into every spectrum, local keys win (pyteomics
            # ``use_header=True`` default).
            key, _, value = line.partition("=")
            header[key.strip().upper()] = value.strip()


def _make_spectrum(params: dict, mz: List[float],
                   intensity: List[float]) -> Union[Spectrum, None]:
    try:
        identifier = params["TITLE"]
        precursor_mz = float(params["PEPMASS"].split()[0])
        retention_time = float(params.get("RTINSECONDS", -1))
        charge = (
            _parse_charge(params["CHARGE"]) if "CHARGE" in params else None
        )
        return Spectrum(
            identifier,
            precursor_mz,
            charge,
            np.asarray(mz, np.float32),
            np.asarray(intensity, np.float32),
            retention_time,
        )
    except (ValueError, KeyError, IndexError):
        # Silently skip malformed spectra (reference mgf_io.py:27-30).
        # IndexError: an empty value ("PEPMASS=" / "CHARGE=") must skip
        # the spectrum like the native scanner does, not abort the file.
        return None


def write_spectra(filename: str, spectra: Iterable[Spectrum]) -> None:
    """Write spectra to an MGF file (reference ``mgf_io.py:70-116``)."""
    with open(filename, "w") as f_out:
        for spectrum in spectra:
            f_out.write("BEGIN IONS\n")
            f_out.write(f"TITLE={spectrum.identifier}\n")
            f_out.write(f"PEPMASS={spectrum.precursor_mz}\n")
            charge = spectrum.precursor_charge
            if charge is not None and not (
                isinstance(charge, float) and np.isnan(charge)
            ):
                charge = int(charge)
                sign = "+" if charge >= 0 else "-"
                f_out.write(f"CHARGE={abs(charge)}{sign}\n")
            if getattr(spectrum, "retention_time", None) is not None:
                f_out.write(f"RTINSECONDS={spectrum.retention_time}\n")
            if getattr(spectrum, "scan", None) is not None:
                f_out.write(f"SCAN={spectrum.scan}\n")
            if getattr(spectrum, "cluster", None) is not None:
                f_out.write(f"CLUSTER={spectrum.cluster}\n")
            for mz, intensity in zip(spectrum.mz, spectrum.intensity):
                f_out.write(f"{mz} {intensity}\n")
            f_out.write("END IONS\n\n")
