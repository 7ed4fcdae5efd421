"""Public Python API of the PyTorch/CUDA port.

The same surface as ``falcon_tpu.api``::

    import falcon_tpu_torch

    result = falcon_tpu_torch.cluster_files(["peaks/*.mgf"])
    result.cluster            # np.int64 label per spectrum
    result.spectrum_id        # identifiers aligned with the labels
    ann = falcon_tpu_torch.cluster_files(
        ["peaks/*.mgf"], backend="ann", eps=0.10)

Options take the CLI option names as keyword arguments and reach the CLI
unchanged (``ann_index``, ``eps``, ``n_neighbors`` and the other ann
options included).  With ``output``
the CSV/MGF files are written exactly as the CLI writes them; without it
nothing is written.  Invalid inputs raise (``ValueError``,
``FileExistsError``, ``NotImplementedError`` for options not ported yet)
instead of returning exit codes.  The configuration is a process-wide
singleton, so call :func:`cluster` from one thread at a time.
"""

import contextlib
import io
import os
import shutil
import tempfile
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Union

import numpy as np

from .ms_io.containers import Spectrum
from .store.store import NULL_CHARGE

__all__ = ["cluster", "ClusterResult", "NULL_CHARGE"]


@dataclass
class ClusterResult:
    """Cluster assignments, one entry per kept (quality-passing) spectrum.

    Rows are in charge-major store order (all spectra of one precursor
    charge, then the next); use :meth:`to_rows` or numpy fancy indexing
    to reorder.  ``precursor_charge`` uses the ``NULL_CHARGE`` sentinel
    (int16 min) for spectra without a charge, matching the columnar
    store; the CSV export renders those as an empty field.
    """

    filename: np.ndarray
    spectrum_id: np.ndarray
    precursor_charge: np.ndarray
    precursor_mz: np.ndarray
    retention_time: np.ndarray
    cluster: np.ndarray
    representatives: List[Spectrum] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.cluster)

    @property
    def n_clusters(self) -> int:
        return len(np.unique(self.cluster))

    def to_rows(self) -> List[dict]:
        """Rows as plain dicts (missing charge becomes ``None``)."""
        charges = [
            None if c == NULL_CHARGE else int(c)
            for c in self.precursor_charge
        ]
        return [
            {
                "filename": str(f),
                "spectrum_id": str(s),
                "precursor_charge": c,
                "precursor_mz": float(m),
                "retention_time": float(r),
                "cluster": int(k),
            }
            for f, s, c, m, r, k in zip(
                self.filename, self.spectrum_id, charges,
                self.precursor_mz, self.retention_time, self.cluster,
            )
        ]


# Options that are presence-only CLI flags (store_true).
_FLAG_OPTIONS = frozenset({"overwrite", "export_representatives"})
# Options taking multiple CLI values (passed as a tuple/list).
_MULTI_OPTIONS = frozenset({"precursor_tol"})


def _option_names() -> frozenset:
    """The configurable option surface, derived from the CLI parser so
    the API can never drift from it."""
    from .config import config

    skip = {"input_filenames", "output_filename", "help", "config"}
    return frozenset(
        a.dest for a in config._parser._actions if a.dest not in skip
    )


def cluster(
    inputs: Union[str, Sequence[str]],
    output: Optional[str] = None,
    **options,
) -> ClusterResult:
    """Run the full clustering pipeline and return in-memory results.

    ``inputs``: one glob pattern / path or a sequence of them.
    ``output``: optional output prefix for ``{output}.csv`` (and
    ``{output}.mgf`` with ``export_representatives=True``).
    ``**options``: any CLI option by name; ``None`` means the default.
    Unknown names raise ``ValueError``.
    """
    from . import cli
    from .config import config

    if isinstance(inputs, (str, os.PathLike)):
        inputs = [inputs]
    inputs = [os.fspath(p) for p in inputs]
    if not inputs:
        raise ValueError("No input files or patterns given")

    known = _option_names()
    args: List[str] = list(inputs)
    placeholder_dir = None
    if output is not None:
        args.append(os.fspath(output))
    else:
        # The output positional is required by the shared parser; the
        # placeholder is never written to (write_outputs stays False).
        placeholder_dir = tempfile.mkdtemp(prefix="falcon_tpu_torch_api_")
        args.append(os.path.join(placeholder_dir, "out"))
    for name, value in options.items():
        if name not in known:
            raise ValueError(
                f"Unknown option {name!r} (valid options: "
                f"{', '.join(sorted(known))})"
            )
        if value is None:
            continue
        if name in _FLAG_OPTIONS:
            if value:
                args.append(f"--{name}")
        elif name in _MULTI_OPTIONS:
            args.append(f"--{name}")
            args.extend(str(v) for v in value)
        else:
            args.extend([f"--{name}", str(value)])

    # Pre-parse under a scoped stderr redirect so a parser error becomes
    # a ValueError carrying argparse's message.
    err = io.StringIO()
    try:
        with contextlib.redirect_stderr(err):
            config.parse(args)
    except SystemExit as exc:
        detail = err.getvalue().strip()
        raise ValueError(
            detail or f"Invalid options (parser exited {exc.code})"
        ) from None

    collect: dict = {"write_outputs": output is not None}
    try:
        rc = cli.main(args, _collect=collect)
        if rc != 0:
            raise RuntimeError(f"Clustering pipeline exited {rc}")
    finally:
        if placeholder_dir is not None:
            shutil.rmtree(placeholder_dir, ignore_errors=True)

    a = collect["assignments"]
    return ClusterResult(
        filename=a["filename"],
        spectrum_id=a["identifier"],
        precursor_charge=a["precursor_charge"],
        precursor_mz=a["precursor_mz"],
        retention_time=a["retention_time"],
        cluster=a["cluster"],
        representatives=collect.get("representatives", []),
    )
