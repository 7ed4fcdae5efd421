"""Extension-based peak-file I/O dispatch.

Behavioral parity with reference ``falcon/ms_io/ms_io.py``: readers for
.mgf/.mzml/.mzxml (error on missing file or unknown extension,
``ms_io.py:28-38``), writer for MGF only (``ms_io.py:58-66``) — implemented
here as a table-driven dispatch.  Beyond the reference: ``.msp``
spectral libraries (promised by the reference's docstring, never
implemented there) and gzipped inputs (``.mgf.gz`` / ``.mzML.gz`` /
``.mzXML.gz`` — the form public proteomics archives ship) are read
transparently.
"""

import logging
import os
from typing import Iterable, Iterator, Optional

from .containers import Spectrum
from . import mgf_io, msp_io, mzml_io, mzxml_io

logger = logging.getLogger("falcon_tpu")

_READERS = {
    ".mgf": mgf_io,
    # The reference docstring promises MSP ("Supported file formats are
    # MGF, MSP, mzML, mzXML", falcon/ms_io/ms_io.py:15) but registers
    # no reader; falcon-tpu implements it (msp_io.py).
    ".msp": msp_io,
    ".mzml": mzml_io,
    ".mzxml": mzxml_io,
}

_WRITERS = {
    ".mgf": mgf_io,
}


def decompress_to_temp(filename: str) -> Optional[str]:
    """Decompress a ``.gz`` peak file to a temp file, or None if not gz.

    The inner extension is preserved (``x.mzML.gz`` → ``*.mzml``) so
    downstream extension dispatch — including the native scanners —
    works on the temp path unchanged; the caller owns deletion.  A
    corrupt or truncated gzip stream decompresses as far as possible
    with a warning, mirroring the truncated-document handling of the
    XML readers.
    """
    if not filename.lower().endswith(".gz"):
        return None
    import gzip
    import shutil
    import tempfile

    import zlib

    inner = os.path.splitext(os.path.splitext(filename)[0])[1].lower()
    fd, tmp_path = tempfile.mkstemp(suffix=inner or ".peakfile")
    try:
        with os.fdopen(fd, "wb") as dst:
            with gzip.open(filename, "rb") as src:
                shutil.copyfileobj(src, dst, 1 << 20)
    except (OSError, EOFError, zlib.error) as e:
        # OSError covers BadGzipFile, EOFError a truncated stream, and
        # zlib.error corrupt deflate data MID-stream — all three must
        # degrade to the decompressed prefix, not abort the whole run.
        logger.warning(
            "Corrupt or truncated gzip stream in %s: %s (parsing the "
            "decompressed prefix)", filename, e,
        )
    return tmp_path


def get_spectra(filename: str) -> Iterator[Spectrum]:
    """Get the MS/MS spectra from the given file (MGF, mzML, or mzXML;
    optionally gzipped)."""
    if not os.path.isfile(filename):
        raise ValueError(f"Non-existing peak file: {filename!r} not found")

    base, ext = os.path.splitext(filename.lower())
    if ext == ".gz":
        inner_ext = os.path.splitext(base)[1]
        if inner_ext not in _READERS:
            raise ValueError(
                f"Unknown spectrum file type: no reader registered for "
                f'extension "{inner_ext}.gz"'
            )
        tmp_path = decompress_to_temp(filename)
        try:
            yield from _READERS[inner_ext].get_spectra(tmp_path)
        finally:
            os.remove(tmp_path)
        return

    reader = _READERS.get(ext)
    if reader is None:
        raise ValueError(
            f"Unknown spectrum file type: no reader registered for "
            f'extension "{ext}"'
        )
    yield from reader.get_spectra(filename)


def write_spectra(filename: str, spectra: Iterable[Spectrum]) -> None:
    """Write the given spectra to a peak file (MGF only)."""
    ext = os.path.splitext(filename.lower())[1]
    writer = _WRITERS.get(ext)
    if writer is None:
        raise ValueError(
            f'Unsupported peak file format "{ext}" — spectra can only be '
            f"exported as MGF"
        )
    writer.write_spectra(filename, spectra)
