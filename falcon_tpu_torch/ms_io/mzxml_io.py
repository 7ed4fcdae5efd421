"""mzXML reading.

First-party streaming parser replacing ``pyteomics.mzxml`` as used by the
reference (``falcon/ms_io/mzxml_io.py``).  Behavioral parity:

- only scans with msLevel > 1 are yielded (reference ``mzxml_io.py:33``).
- identifier = the scan ``num``; retention time from the ``retentionTime``
  xs:duration attribute, normalized to seconds (absent -> -1)
  (reference ``mzxml_io.py:55-58``).  DIVERGENCE (SURVEY.md §3.5): all
  readers in this package report retention time in SECONDS so ``rt_tol``
  is format-independent; pyteomics (and hence the reference) reports
  mzXML retentionTime in minutes.
- precursor m/z from the <precursorMz> element text; charge from its
  ``precursorCharge`` attribute, absent -> ``None``
  (reference ``mzxml_io.py:60-64``).
- malformed scans are skipped silently; XML-level errors warn and stop
  (reference ``mzxml_io.py:33-38``).

Peaks are decoded from the <peaks> element: base64, network (big-endian)
byte order, 32/64-bit floats, interleaved m/z-intensity pairs, optional
zlib compression.  Scans with any other compressionType (e.g.
MS-Numpress) are skipped with a once-per-file warning (SURVEY.md §3.5).
"""

import base64
import logging
import re
import zlib
from typing import IO, Iterator, Optional, Union

import numpy as np

try:
    from lxml import etree
except ImportError:  # pragma: no cover
    import xml.etree.ElementTree as etree

from .containers import Spectrum
from .mzml_io import _UnsupportedCompression

logger = logging.getLogger("falcon_tpu")

# lxml raises XMLSyntaxError; the stdlib ElementTree fallback raises
# ParseError — resolve the catchable tuple at import time.
_XML_ERRORS = (
    (etree.XMLSyntaxError,) if hasattr(etree, "XMLSyntaxError")
    else (etree.ParseError,)
)

_DURATION_RE = re.compile(
    r"^(-?)P(?:(\d+(?:\.\d+)?)D)?"
    r"(?:T(?:(\d+(?:\.\d+)?)H)?(?:(\d+(?:\.\d+)?)M)?(?:(\d+(?:\.\d+)?)S)?)?$"
)


def _parse_retention_time(value: Optional[str]) -> float:
    """Parse an xs:duration (e.g. 'PT123.45S') into seconds."""
    if value is None:
        return -1.0
    match = _DURATION_RE.match(value.strip())
    if match is None:
        try:
            return float(value)
        except ValueError:
            return -1.0
    sign, days, hours, minutes, seconds = match.groups()
    total = (
        float(days or 0) * 86400
        + float(hours or 0) * 3600
        + float(minutes or 0) * 60
        + float(seconds or 0)
    )
    return -total if sign == "-" else total


def _local(tag) -> str:
    return str(tag).rsplit("}", 1)[-1]


def _parse_scan(elem) -> Optional[Spectrum]:
    ms_level = int(elem.get("msLevel", -1))
    if ms_level <= 1:
        return None
    spectrum_id = elem.get("num")
    retention_time = _parse_retention_time(elem.get("retentionTime"))

    precursor_mz, precursor_charge = None, None
    mz_array = intensity_array = None
    for child in elem.iter():
        tag = _local(child.tag)
        if tag == "precursorMz" and precursor_mz is None:
            precursor_mz = float(child.text)
            charge = child.get("precursorCharge")
            precursor_charge = int(charge) if charge is not None else None
        elif tag == "peaks":
            precision = int(child.get("precision", 32))
            compression = (child.get("compressionType") or "none").lower()
            byte_order = (child.get("byteOrder") or "network").lower()
            if compression not in ("zlib", "none", ""):
                # e.g. MS-Numpress: decoding as raw floats would be
                # silent garbage — skip the scan instead (before paying
                # for the base64 decode).
                raise _UnsupportedCompression(compression)
            data = base64.b64decode(child.text or "")
            if compression == "zlib":
                data = zlib.decompress(data)
            dtype = np.dtype(np.float64 if precision == 64 else np.float32)
            dtype = dtype.newbyteorder(
                ">" if byte_order == "network" else "<"
            )
            pairs = np.frombuffer(data, dtype=dtype)
            mz_array = pairs[0::2].astype(np.float32)
            intensity_array = pairs[1::2].astype(np.float32)

    if spectrum_id is None or precursor_mz is None or mz_array is None:
        raise KeyError("incomplete scan")
    return Spectrum(
        spectrum_id,
        precursor_mz,
        precursor_charge,
        mz_array,
        intensity_array,
        retention_time,
    )


def get_spectra(source: Union[IO, str]) -> Iterator[Spectrum]:
    """Iterate over the MS/MS scans (msLevel > 1) in an mzXML file."""
    warned_compression = False
    try:
        for _, elem in etree.iterparse(source, events=("end",)):
            if _local(elem.tag) != "scan":
                continue
            try:
                spec = _parse_scan(elem)
                if spec is not None:
                    yield spec
            except _UnsupportedCompression as e:
                if not warned_compression:
                    logger.warning(
                        "Skipping scans with unsupported peak "
                        "compression %s in %s", e, source
                    )
                    warned_compression = True
            except (ValueError, KeyError, TypeError, zlib.error):
                # TypeError: empty <precursorMz/> (float(None));
                # zlib.error: corrupt compressed peaks — skip the scan,
                # keep reading the file.
                pass
            finally:
                elem.clear()
    except _XML_ERRORS as e:
        logger.warning("Failed to read file %s: %s", source, e)
