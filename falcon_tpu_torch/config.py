"""Command-line and file-based configuration.

Keeps the exact CLI surface of the reference (all 2 positionals + 16 options
of ``falcon/config.py:52-183``, same names, defaults, and semantics,
including the ``config.ini`` file with CLI-over-file precedence,
``falcon/config.py:38-49``) and adds back the published-algorithm knobs the
reference's README still documents (``eps``, ``low_dim``, ``n_probe``,
``n_neighbors``, ``n_neighbors_ann``; cf. reference ``README.md:101-117``)
plus TPU-engine settings.

Implemented first-party on top of ``argparse`` (``configargparse`` is not a
dependency of this framework): a ``config.ini`` in the working directory (or
a file passed via ``-c/--config``) supplies ``key = value`` defaults that the
command line overrides.
"""

import argparse
import math
import os
import shlex
import textwrap
from typing import List, Union


class NewlineTextHelpFormatter(argparse.HelpFormatter):
    """Help formatter that preserves newlines (reference ``config.py:9-21``)."""

    def _fill_text(self, text, width, indent):
        return "\n".join(
            textwrap.fill(
                line,
                width,
                initial_indent=indent,
                subsequent_indent=indent,
                replace_whitespace=False,
            ).strip()
            for line in text.splitlines(keepends=True)
        )


def _read_config_file(path: str) -> dict:
    """Parse a simple ``key = value`` config file (configargparse-style).

    Lines starting with ``#`` or ``;`` and section headers are ignored.
    Values for multi-argument options (e.g. ``precursor_tol``) are
    whitespace-separated.  Boolean flags accept true/yes/on/1.
    """
    values = {}
    with open(path) as f:
        for raw in f:
            line = raw.strip()
            if not line or line[0] in "#;[":
                continue
            if "=" in line:
                key, _, val = line.partition("=")
            elif ":" in line:
                key, _, val = line.partition(":")
            else:
                key, val = line, "true"
            values[key.strip().lstrip("-")] = val.strip()
    return values


_TRUE_STRINGS = frozenset({"true", "yes", "on", "1"})


class Config:
    """Singleton configuration with attribute access after :meth:`parse`.

    Mirrors reference ``falcon/config.py:24-209``: settings are exposed via
    ``config.<option>`` / ``config["<option>"]``; accessing before
    :meth:`parse` raises ``RuntimeError``.
    """

    def __init__(self) -> None:
        self._parser = argparse.ArgumentParser(
            prog="falcon-tpu",
            description=(
                "falcon-tpu: TPU-native spectrum clustering using nearest "
                "neighbor searching\n"
                "===============================================  "
                "==================\n\n"
                "Official reference: https://github.com/bittremieux/falcon\n\n"
            ),
            formatter_class=NewlineTextHelpFormatter,
        )
        p = self._parser
        p.add_argument(
            "-c",
            "--config",
            default=None,
            help="Config file path (default: config.ini in the working "
            "directory, if present).",
        )

        # IO (reference config.py:52-77)
        p.add_argument(
            "input_filenames",
            nargs="+",
            help="Input peak files (supported formats: .mzML, .mzXML, .MGF).",
        )
        p.add_argument("output_filename", help="Output file name.")
        p.add_argument(
            "--work_dir",
            default=None,
            help="Working directory (default: temporary directory).",
        )
        p.add_argument(
            "--overwrite",
            action="store_true",
            help="Overwrite existing results (default: don't overwrite).",
        )
        p.add_argument(
            "--export_representatives",
            action="store_true",
            help="Export cluster representatives to an MGF file "
            "(default: no export).",
        )

        # CLUSTERING (reference config.py:79-124)
        p.add_argument(
            "--precursor_tol",
            nargs=2,
            default=[20, "ppm"],
            help="Precursor tolerance mass and mode (default: 20 ppm). "
            'Mode should be either "ppm" or "Da".',
        )
        p.add_argument(
            "--rt_tol",
            type=float,
            default=None,
            help="Retention time tolerance (default: no retention time "
            "filtering).",
        )
        p.add_argument(
            "--fragment_tol",
            type=float,
            default=0.05,
            help="Fragment mass tolerance in m/z (default: %(default)s m/z).",
        )
        p.add_argument(
            "--linkage",
            type=str,
            default="complete",
            choices=["single", "complete", "average"],
            help="Linkage criterion for hierarchical clustering "
            "(default: %(default)s).",
        )
        p.add_argument(
            "--distance_threshold",
            type=float,
            default=0.1,
            help="The distance threshold parameter (cosine distance) for "
            "clustering (default: %(default)s). Relevant cosine distance "
            "thresholds are typically between 0.05 and 0.30.",
        )
        p.add_argument(
            "--min_matched_peaks",
            type=int,
            default=0,
            help="Minimum number of matched peaks to consider the spectra "
            "similar (default: %(default)s). Typically 6 for metabolomics "
            "data.",
        )
        p.add_argument(
            "--batch_size",
            type=int,
            default=2**15,
            help="Batch size for clustering (default: %(default)s).",
        )

        # PREPROCESSING (reference config.py:126-183)
        p.add_argument(
            "--min_peaks",
            default=5,
            type=int,
            help="Discard spectra with fewer than this number of peaks "
            "(default: %(default)s).",
        )
        p.add_argument(
            "--min_mz_range",
            default=250.0,
            type=float,
            help="Discard spectra with a smaller mass range "
            "(default: %(default)s m/z).",
        )
        p.add_argument(
            "--min_mz",
            default=101.0,
            type=float,
            help="Minimum peak m/z value (inclusive, "
            "default: %(default)s m/z).",
        )
        p.add_argument(
            "--max_mz",
            default=1500.0,
            type=float,
            help="Maximum peak m/z value (inclusive, "
            "default: %(default)s m/z).",
        )
        p.add_argument(
            "--remove_precursor_tol",
            default=1.5,
            type=float,
            help="Window around the precursor mass to remove peaks "
            "(default: %(default)s m/z).",
        )
        p.add_argument(
            "--min_intensity",
            default=0.01,
            type=float,
            help="Remove peaks with a lower intensity relative to the base "
            "intensity (default: %(default)s).",
        )
        p.add_argument(
            "--max_peaks_used",
            default=50,
            type=int,
            help="Only use the specified most intense peaks in the spectra "
            "(default: %(default)s).",
        )
        p.add_argument(
            "--scaling",
            default="off",
            type=str,
            choices=["off", "root", "log", "rank"],
            help="Peak scaling method used to reduce the influence of very "
            "intense peaks (default: %(default)s).",
        )

        # TPU ENGINE / PUBLISHED-ALGORITHM KNOBS (new; cf. reference
        # README.md:101-117 which documents eps/low_dim/n_probe/n_neighbors
        # for the published hashing+IVF+DBSCAN algorithm).
        p.add_argument(
            "--backend",
            default="exact",
            type=str,
            choices=["exact", "ann"],
            help="Similarity backend: 'exact' reproduces the reference's "
            "all-pairs peak-matching cosine + hierarchical clustering; "
            "'ann' is the scalable vectorize->hash->IVF->k-NN engine with "
            "density clustering (default: %(default)s).",
        )
        p.add_argument(
            "--eps",
            default=0.1,
            type=float,
            help="[ann backend] Maximum cosine distance between two spectra "
            "to be considered neighbors during density clustering "
            "(default: %(default)s).",
        )
        p.add_argument(
            "--low_dim",
            default=400,
            type=int,
            help="[ann backend] Dimensionality of the feature-hashed "
            "spectrum vectors (default: %(default)s).",
        )
        p.add_argument(
            "--n_neighbors",
            default=64,
            type=int,
            help="[ann backend] Number of neighbors to include in the "
            "sparse pairwise distance matrix (default: %(default)s).",
        )
        p.add_argument(
            "--n_neighbors_ann",
            default=128,
            type=int,
            help="[ann backend] Number of neighbors to retrieve from the "
            "ANN index (default: %(default)s).",
        )
        p.add_argument(
            "--n_probe",
            default=32,
            type=int,
            help="[ann backend] Number of IVF lists to inspect per query "
            "(default: %(default)s).",
        )
        p.add_argument(
            "--min_samples",
            default=2,
            type=int,
            help="[ann backend] Minimum number of samples in a density "
            "neighborhood for a spectrum to be a core point "
            "(default: %(default)s; used by --cluster_method dbscan).",
        )
        p.add_argument(
            "--cluster_method",
            default="linkage",
            type=str,
            choices=["linkage", "dbscan"],
            help="[ann backend] Cluster formation from the sparse "
            "neighbor graph: 'linkage' (default) runs the reference's "
            "hierarchical clustering (--linkage criterion, cut at --eps) "
            "on exact peak-matching distances inside each eps-connected "
            "component, so labels match the exact backend; 'dbscan' is "
            "the published algorithm's density clustering "
            "(--min_samples).",
        )
        p.add_argument(
            "--ann_index",
            default="auto",
            type=str,
            choices=["auto", "brute", "ivf", "exact"],
            help="[ann backend] Nearest-neighbor index: 'brute' = hashed "
            "banded matmul search, 'ivf' = TPU IVF (k-means coarse "
            "quantizer + n_probe list scans), 'auto' = ivf for very "
            "large charge buckets, 'exact' = hash-free banded "
            "peak-matching-cosine top-k (oracle path; recall@k = 1.0 by "
            "construction) (default: %(default)s).",
        )
        p.add_argument(
            "--hash_seed",
            default=0,
            type=int,
            help="[ann backend] Seed for the MurmurHash3 feature hashing "
            "(default: %(default)s).",
        )
        p.add_argument(
            "--rerank",
            default="exact",
            type=str,
            choices=["exact", "off"],
            help="[ann backend] Re-score the hashed nearest-neighbor "
            "candidates with the exact peak-matching cosine on device "
            "before density clustering ('exact', default), or cluster on "
            "hashed-vector distances like the published falcon algorithm "
            "('off').",
        )
        p.add_argument(
            "--representative_method",
            default="medoid",
            type=str,
            choices=["medoid", "consensus"],
            help="How to build exported cluster representatives: 'medoid' "
            "exports the spectrum minimizing the summed in-cluster "
            "distance (reference behavior); 'consensus' constructs a "
            "merged spectrum from all cluster members on device "
            "(default: %(default)s).",
        )
        p.add_argument(
            "--consensus_min_fraction",
            default=0.5,
            type=float,
            help="[consensus representatives] Minimum fraction of cluster "
            "members that must support a fragment bin for it to enter "
            "the consensus spectrum (default: %(default)s).",
        )
        p.add_argument(
            "--devices",
            default=None,
            type=int,
            help="Number of TPU devices to shard clustering over "
            "(default: all visible devices).",
        )
        p.add_argument(
            "--profile",
            default=None,
            type=str,
            metavar="DIR",
            help="Capture a JAX device trace into DIR (TensorBoard/"
            "Perfetto format) and log a per-phase timing summary "
            "(default: timing summary only at DEBUG level).",
        )

        self._namespace = None

    def parse(self, args_str: Union[str, List[str], None] = None) -> None:
        """Parse settings; CLI args override config-file values.

        Mirrors reference ``config.py:187-201`` (including the float cast of
        ``precursor_tol[0]``).
        """
        if isinstance(args_str, str):
            args = shlex.split(args_str)
        else:
            args = args_str  # None -> sys.argv

        # First pass: find a config file (explicit -c/--config or ./config.ini).
        pre = argparse.ArgumentParser(add_help=False)
        pre.add_argument("-c", "--config", default=None)
        pre_ns, _ = pre.parse_known_args(args)
        config_path = pre_ns.config
        if config_path is None and os.path.isfile("config.ini"):
            config_path = "config.ini"
        if config_path is not None:
            # Config-file values are applied via set_defaults, which
            # bypasses argparse's own validation — so validate here and
            # report through parser.error (clean message, exit code 2)
            # instead of leaking a traceback.  Unknown keys are an
            # error, like configargparse (the reference's config layer)
            # treats unrecognized config-file entries.
            try:
                file_values = _read_config_file(config_path)
            except (OSError, UnicodeDecodeError) as e:
                self._parser.error(
                    f"could not read config file {config_path}: {e}"
                )
            skip = {"help", "config", "input_filenames", "output_filename"}
            known = {
                action.dest for action in self._parser._actions
                if action.dest not in skip
            }
            unknown = sorted(set(file_values) - known)
            if unknown:
                self._parser.error(
                    f"unknown option(s) in config file {config_path}: "
                    + ", ".join(unknown)
                )
            defaults = {}
            for action in self._parser._actions:
                if action.dest in skip or action.dest not in file_values:
                    continue
                raw = file_values[action.dest]
                if isinstance(action, argparse._StoreTrueAction):
                    defaults[action.dest] = raw.lower() in _TRUE_STRINGS
                elif action.nargs == 2:
                    parts = raw.split()
                    if len(parts) != 2:
                        self._parser.error(
                            f"option '{action.dest}' in config file "
                            f"{config_path} needs 2 values, got {raw!r}"
                        )
                    defaults[action.dest] = parts
                elif action.type is not None:
                    try:
                        defaults[action.dest] = action.type(raw)
                    except (TypeError, ValueError):
                        self._parser.error(
                            f"option '{action.dest}' in config file "
                            f"{config_path}: invalid value {raw!r}"
                        )
                else:
                    defaults[action.dest] = raw
                if (action.choices is not None
                        and defaults[action.dest] not in action.choices):
                    self._parser.error(
                        f"option '{action.dest}' in config file "
                        f"{config_path}: {raw!r} is not one of "
                        + ", ".join(map(str, action.choices))
                    )
            self._parser.set_defaults(**defaults)

        self._namespace = vars(self._parser.parse_args(args))
        try:
            self._namespace["precursor_tol"] = [
                float(self._namespace["precursor_tol"][0]),
                str(self._namespace["precursor_tol"][1]),
            ]
        except (TypeError, ValueError):
            # The reference crashes on a non-numeric tolerance (its own
            # float cast, config.py:187-201); report cleanly instead.
            self._parser.error(
                "argument --precursor_tol: invalid numeric value "
                f"{self._namespace['precursor_tol'][0]!r}"
            )
        self._check_bounds()

    # Options whose value must be strictly positive: zero/negative is
    # mathematically undefined downstream (fragment_tol=0 divides by
    # zero in bin sizing; low_dim=0 hashes into an empty space) or
    # silently degenerate (max_peaks_used=0 drops every peak).
    _POSITIVE_OPTIONS = (
        "fragment_tol", "eps", "batch_size", "min_peaks",
        "max_peaks_used", "low_dim", "n_neighbors", "n_neighbors_ann",
        "n_probe", "min_samples", "devices", "consensus_min_fraction",
    )
    # Options where zero is meaningful (e.g. an exact-match tolerance)
    # but a negative value never is.
    _NON_NEGATIVE_OPTIONS = (
        "rt_tol", "distance_threshold", "min_mz_range",
        "remove_precursor_tol", "min_intensity", "min_matched_peaks",
    )
    # Float options that only need to be finite (NaN disables every
    # comparison it reaches; the m/z window handles any finite bounds).
    _FINITE_OPTIONS = ("min_mz", "max_mz")

    def _check_bounds(self):
        """Reject numeric option values the pipeline cannot mean.

        The reference performs no such validation — a zero fragment
        tolerance crashes deep inside its vectorization and a NaN
        tolerance silently declares nothing similar; reporting at the
        CLI boundary is a deliberate robustness divergence
        (SURVEY.md §5f).
        """
        def _bad(opt, value, requirement):
            self._parser.error(
                f"argument --{opt}: {requirement}, got {value!r}")

        for opt in self._POSITIVE_OPTIONS:
            v = self._namespace.get(opt)
            if v is None:
                continue
            if isinstance(v, float) and not math.isfinite(v):
                _bad(opt, v, "value must be finite")
            if v <= 0:
                _bad(opt, v, "value must be positive")
        for opt in self._NON_NEGATIVE_OPTIONS:
            v = self._namespace.get(opt)
            if v is None:
                continue
            if isinstance(v, float) and not math.isfinite(v):
                _bad(opt, v, "value must be finite")
            if v < 0:
                _bad(opt, v, "value must not be negative")
        for opt in self._FINITE_OPTIONS:
            v = self._namespace.get(opt)
            if v is not None and not math.isfinite(v):
                _bad(opt, v, "value must be finite")
        tol = self._namespace.get("precursor_tol")
        if tol is not None and (
                not math.isfinite(tol[0]) or tol[0] < 0):
            _bad("precursor_tol", tol[0],
                 "tolerance must be finite and not negative")

    def __getattr__(self, option):
        if option.startswith("_"):
            raise AttributeError(option)
        if self._namespace is None:
            raise RuntimeError("The configuration has not been initialized")
        try:
            return self._namespace[option]
        except KeyError:
            # AttributeError keeps hasattr()/getattr(default) semantics
            # for unknown options instead of leaking a KeyError.
            raise AttributeError(option) from None

    def __setattr__(self, option, value):
        if option.startswith("_"):
            super().__setattr__(option, value)
        else:
            self._namespace[option] = value

    def __getitem__(self, item):
        return self.__getattr__(item)


config = Config()
