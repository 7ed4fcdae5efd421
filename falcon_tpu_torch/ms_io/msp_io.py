"""MSP (NIST / GNPS spectral-library text format) reading.

The reference ADVERTISES MSP support ("Supported file formats are MGF,
MSP, mzML, mzXML", ``falcon/ms_io/ms_io.py:15``) but registers no MSP
reader — the promise without the implementation.  falcon-tpu delivers
it: a first-party parser for the common NIST/GNPS dialect.

Format handled::

    Name: some compound
    PrecursorMZ: 500.25          (also PRECURSORMZ / Precursor_m/z)
    Charge: 2+                   (or Comment: ... Charge=2 ...)
    Comment: Parent=500.25 RTINSECONDS=12.5 ...
    Num Peaks: 4                 (case-insensitive; also "Num peaks")
    100.1 10.0; 200.2 20.0       (pairs split on ';' and whitespace)
    300.5 5.0 "annotation"       (trailing annotations ignored)

    Name: next entry ...

Semantics, mirroring the MGF reader's (``mgf_io.py``):

- an entry needs Name (identifier) and a precursor m/z — taken from
  ``PrecursorMZ:``, else ``Parent=`` inside ``Comment:``, else ``MW:``;
  entries missing either are skipped silently.
- charge from ``Charge:`` ("2", "2+", "2-") or ``Charge=`` in the
  comment; absent -> ``None``.
- retention time from ``RTINSECONDS=`` (seconds) or ``RetentionTime=``
  (treated as seconds, consistent with the all-readers-report-seconds
  rule, SURVEY.md §3.5) in the comment or as a header line; absent ->
  ``-1``.
- an unparseable peak pair invalidates the whole entry (skipped
  silently), like the MGF reader's malformed-spectrum handling.
- files decode as UTF-8 with undecodable bytes replaced, so corrupt or
  binary files flow through the skip paths (tests/test_fuzz.py).
"""

import logging
import re
from typing import IO, Iterator, List, Optional, Union

import numpy as np

from .containers import Spectrum
from .mgf_io import _parse_charge

logger = logging.getLogger("falcon_tpu")

# key=value pairs inside a Comment: line — values either quoted (may
# contain spaces) or a single non-space run.
_COMMENT_KV = re.compile(r'(\w[\w/.-]*)=("[^"]*"|\S+)')


def get_spectra(source: Union[IO, str]) -> Iterator[Spectrum]:
    """Iterate over the spectra in an MSP library file."""
    if isinstance(source, str):
        with open(source, encoding="utf-8", errors="replace") as f_in:
            yield from _iter_msp(f_in)
    else:
        yield from _iter_msp(source)


def _iter_msp(f_in: IO) -> Iterator[Spectrum]:
    fields: dict = {}
    comment_kv: dict = {}
    mz: List[float] = []
    intensity: List[float] = []
    in_peaks = False
    malformed = False
    started = False

    def flush() -> Optional[Spectrum]:
        if not started or malformed:
            return None
        return _make_spectrum(fields, comment_kv, mz, intensity)

    for raw in f_in:
        line = raw.strip()
        if not line:
            # Blank lines end the peak list (entry boundary in most
            # dialects) but tolerate blanks between header fields.
            if in_peaks:
                spec = flush()
                if spec is not None:
                    yield spec
                fields, comment_kv = {}, {}
                mz, intensity = [], []
                in_peaks = malformed = started = False
            continue
        if line[0] in "#;" and not in_peaks:
            continue  # comment outside an entry
        key, sep, value = line.partition(":")
        if sep and key.strip().lower() == "name":
            # A new Name ends the previous entry — whether we were in
            # its header or its peak list (files without blank-line
            # separators).
            spec = flush()
            if spec is not None:
                yield spec
            fields, comment_kv = {}, {}
            mz, intensity = [], []
            in_peaks = malformed = False
            started = True
            fields["name"] = value.strip()
            continue
        if sep and not in_peaks:
            key_l = key.strip().lower()
            value = value.strip()
            if key_l in ("num peaks", "numpeaks", "num_peaks"):
                in_peaks = True
                continue
            if key_l in ("comment", "comments"):
                for m in _COMMENT_KV.finditer(value):
                    comment_kv[m.group(1).lower()] = m.group(2).strip('"')
                continue
            fields[key_l] = value
            continue
        if in_peaks:
            for chunk in line.split(";"):
                tokens = chunk.split()
                if len(tokens) < 2:
                    continue  # empty or single-orphan-token chunk
                try:
                    mz.append(float(tokens[0]))
                    intensity.append(float(tokens[1]))
                except ValueError:
                    malformed = True
                    break
    spec = flush()
    if spec is not None:
        yield spec


def _make_spectrum(fields: dict, comment_kv: dict, mz: List[float],
                   intensity: List[float]) -> Optional[Spectrum]:
    try:
        identifier = fields["name"]
        raw_pre = (
            fields.get("precursormz")
            or fields.get("precursor_m/z")
            or fields.get("precursor m/z")
            or comment_kv.get("parent")
            or fields.get("mw")
        )
        precursor_mz = float(raw_pre.split()[0])
        raw_charge = fields.get("charge") or comment_kv.get("charge")
        charge = _parse_charge(raw_charge) if raw_charge else None
        raw_rt = (
            comment_kv.get("rtinseconds")
            or fields.get("rtinseconds")
            or comment_kv.get("retentiontime")
            or fields.get("retentiontime")
        )
        retention_time = float(raw_rt) if raw_rt else -1.0
        return Spectrum(
            identifier,
            precursor_mz,
            charge,
            np.asarray(mz, np.float32),
            np.asarray(intensity, np.float32),
            retention_time,
        )
    except (AttributeError, ValueError, KeyError, IndexError):
        # Silently skip malformed entries, like the MGF reader.
        return None
