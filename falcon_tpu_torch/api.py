"""Public Python API of the PyTorch/CUDA port.

The same surface as ``falcon_tpu.api``::

    import falcon_tpu_torch

    result = falcon_tpu_torch.cluster_files(["peaks/*.mgf"])
    result.cluster            # np.int64 label per spectrum
    result.spectrum_id        # identifiers aligned with the labels

Options take the CLI option names as keyword arguments.  With ``output``
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
from typing import List, Optional, Sequence, Union

from falcon_tpu.api import (_FLAG_OPTIONS, _MULTI_OPTIONS, NULL_CHARGE,
                            ClusterResult, _option_names)

__all__ = ["cluster", "ClusterResult", "NULL_CHARGE"]


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
    from falcon_tpu.config import config

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
