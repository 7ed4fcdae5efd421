"""mzML reading.

First-party streaming parser replacing ``pyteomics.mzml`` as used by the
reference (``falcon/ms_io/mzml_io.py``).  Behavioral parity:

- only spectra with MS level > 1 are yielded (reference ``mzml_io.py:33``).
- identifier = the ``id`` attribute; retention time from
  scanList/scan "scan start time" (absent -> -1)
  (reference ``mzml_io.py:55-62``).  DIVERGENCE (SURVEY.md §3.5): the
  retention time is normalized to SECONDS (minute-unit cvParams are
  converted) so ``rt_tol`` means the same thing for every input format;
  the reference passes through pyteomics' native unit (typically
  minutes for mzML/mzXML, seconds for MGF ``RTINSECONDS``).
- precursor charge from "charge state" or "possible charge state"; absent
  -> ``None`` (reference ``mzml_io.py:67-72``).
- individual malformed spectra are skipped silently; XML-level errors warn
  and stop iteration over the file (reference ``mzml_io.py:33-38``).

Binary peak arrays are decoded directly: base64 + optional zlib, 32/64-bit
IEEE floats per the cvParam accessions.
"""

import base64
import logging
import zlib
from typing import IO, Iterator, Optional, Union

import numpy as np

try:
    from lxml import etree
except ImportError:  # pragma: no cover - lxml is available in this image
    import xml.etree.ElementTree as etree

from .containers import Spectrum

logger = logging.getLogger("falcon_tpu")

# DIVERGENCE (SURVEY.md §3.5): spectra with MS-Numpress-compressed
# binary arrays are skipped with a once-per-file warning; the reference
# (pyteomics without pynumpress) aborts the whole file instead.

# lxml raises XMLSyntaxError; the stdlib ElementTree fallback raises
# ParseError — resolve the catchable tuple at import time.
_XML_ERRORS = (
    (etree.XMLSyntaxError,) if hasattr(etree, "XMLSyntaxError")
    else (etree.ParseError,)
)

# cvParam accessions (PSI-MS controlled vocabulary).
_ACC_MS_LEVEL = "MS:1000511"
_ACC_MZ_ARRAY = "MS:1000514"
_ACC_INT_ARRAY = "MS:1000515"
_ACC_F64 = "MS:1000523"
_ACC_F32 = "MS:1000521"
_ACC_ZLIB = "MS:1000574"
_ACC_SCAN_START = "MS:1000016"
_ACC_SELECTED_MZ = "MS:1000744"
_ACC_CHARGE = "MS:1000041"
_ACC_POSSIBLE_CHARGE = "MS:1000633"
# MS-Numpress compressions (plain and +zlib combos): not supported —
# decoding their payload as raw IEEE floats would yield silent garbage,
# so spectra carrying them are skipped with a once-per-file warning.
_ACC_NUMPRESS = frozenset((
    "MS:1002312", "MS:1002313", "MS:1002314",
    "MS:1002746", "MS:1002747", "MS:1002748",
))


class _UnsupportedCompression(ValueError):
    pass


def _local(tag) -> str:
    tag = str(tag)
    return tag.rsplit("}", 1)[-1]


def _cv_params(element) -> dict:
    """accession -> value for all direct cvParam children."""
    out = {}
    for child in element:
        if _local(child.tag) == "cvParam":
            out[child.get("accession")] = child.get("value", "")
    return out


def _decode_binary_array(bda) -> Optional[np.ndarray]:
    """Decode one <binaryDataArray>; returns (kind, array) or None."""
    dtype, compressed, kind, payload = np.float64, False, None, None
    unsupported = None
    for child in bda.iter():
        tag = _local(child.tag)
        if tag == "cvParam":
            acc = child.get("accession")
            if acc == _ACC_F32:
                dtype = np.float32
            elif acc == _ACC_F64:
                dtype = np.float64
            elif acc == _ACC_ZLIB:
                compressed = True
            elif acc in _ACC_NUMPRESS:
                unsupported = acc
            elif acc == _ACC_MZ_ARRAY:
                kind = "mz"
            elif acc == _ACC_INT_ARRAY:
                kind = "intensity"
        elif tag == "binary":
            payload = child.text or ""
    if kind is None or payload is None:
        return None
    if unsupported is not None:
        raise _UnsupportedCompression(unsupported)
    data = base64.b64decode(payload)
    if compressed:
        data = zlib.decompress(data)
    return kind, np.frombuffer(data, dtype=np.dtype(dtype).newbyteorder("<"))


def _parse_spectrum(elem) -> Optional[Spectrum]:
    params = _cv_params(elem)
    ms_level = int(params.get(_ACC_MS_LEVEL, -1))
    if ms_level <= 1:
        return None

    spectrum_id = elem.get("id")
    mz_array = intensity_array = None
    retention_time = -1.0
    precursor_mz, precursor_charge = None, None

    for child in elem.iter():
        tag = _local(child.tag)
        if tag == "binaryDataArray":
            decoded = _decode_binary_array(child)
            if decoded is not None:
                kind, arr = decoded
                if kind == "mz":
                    mz_array = arr
                else:
                    intensity_array = arr
        elif tag == "scan":
            for cp in child:
                if (_local(cp.tag) == "cvParam"
                        and cp.get("accession") == _ACC_SCAN_START):
                    retention_time = float(cp.get("value", -1.0))
                    unit = (cp.get("unitName") or "").lower()
                    if (unit.startswith("minute")
                            or cp.get("unitAccession") == "UO:0000031"):
                        retention_time *= 60.0
        elif tag == "selectedIon":
            ion_params = _cv_params(child)
            if _ACC_SELECTED_MZ in ion_params:
                precursor_mz = float(ion_params[_ACC_SELECTED_MZ])
            if _ACC_CHARGE in ion_params:
                precursor_charge = int(ion_params[_ACC_CHARGE])
            elif _ACC_POSSIBLE_CHARGE in ion_params:
                precursor_charge = int(ion_params[_ACC_POSSIBLE_CHARGE])

    if spectrum_id is None or mz_array is None or intensity_array is None \
            or precursor_mz is None:
        raise KeyError("incomplete spectrum")
    return Spectrum(
        spectrum_id,
        precursor_mz,
        precursor_charge,
        mz_array,
        intensity_array,
        retention_time,
    )


def get_spectra(source: Union[IO, str]) -> Iterator[Spectrum]:
    """Iterate over the MS/MS spectra (MS level > 1) in an mzML file."""
    warned_numpress = False
    try:
        for _, elem in etree.iterparse(source, events=("end",)):
            if _local(elem.tag) != "spectrum":
                continue
            try:
                spec = _parse_spectrum(elem)
                if spec is not None:
                    yield spec
            except _UnsupportedCompression as e:
                if not warned_numpress:
                    logger.warning(
                        "Skipping spectra with unsupported binary "
                        "compression %s (MS-Numpress) in %s", e, source
                    )
                    warned_numpress = True
            except (ValueError, KeyError, TypeError, zlib.error):
                # Skip malformed spectra silently (mzml_io.py:33-36).
                # zlib.error: a corrupt compressed peak payload must not
                # abort the remaining spectra in the file.
                pass
            finally:
                elem.clear()
    except _XML_ERRORS as e:
        logger.warning("Failed to read file %s: %s", source, e)
