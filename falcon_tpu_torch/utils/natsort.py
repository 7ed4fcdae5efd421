"""Natural-order sorting.

First-party replacement for the ``natsort`` dependency used by the reference
to order output CSV rows by (filename, spectrum_id)
(reference ``falcon/falcon.py:206-208``).  Numbers embedded in strings are
compared numerically ("scan2" < "scan10").
"""

import re
from typing import Any, Iterable, List, Tuple

_SPLIT_RE = re.compile(r"(\d+)")


def natsort_key(value: Any) -> Tuple:
    """A sort key that orders embedded integers numerically.

    Non-string values sort before strings of the same position, mirroring
    natsort's default handling of mixed types closely enough for the CSV
    export use case (filenames and spectrum identifiers).
    """
    if not isinstance(value, str):
        return ((0, value),)
    parts = _SPLIT_RE.split(value)
    key: List[Tuple[int, Any]] = []
    for i, part in enumerate(parts):
        if i % 2 == 1:  # digit group
            key.append((0, int(part)))
        elif part:
            key.append((1, part))
    return tuple(key)


def natsorted(values: Iterable[Any]) -> List[Any]:
    return sorted(values, key=natsort_key)


def argsort(values: Iterable[Any]) -> List[int]:
    """Indices that natural-sort ``values``."""
    vals = list(values)
    return sorted(range(len(vals)), key=lambda i: natsort_key(vals[i]))
