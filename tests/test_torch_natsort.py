"""The port's natural sort of export ids (``native.natsort_rows``: keys
encoded once a row, a sample sort on threads) held to the JAX package's
order: its ``natsort_key`` and its native comparator sort
``falcon_tpu.native.natsort_pairs``."""

import numpy as np
import pytest

from falcon_tpu import native as j_native
from falcon_tpu.utils.natsort import natsort_key
from falcon_tpu_torch import native as t_native

# Pieces of ids: leading zeros and numerically equal runs of several
# widths, digit runs past 19 digits and past 255 (the key's long length
# form), text of every UTF-8 length, an interior NUL, and nothing at all.
_PIECES = ["0", "00", "007", "7", "70", "10", "010",
           "12345678901234567890123", "0012345678901234567890123",
           "9" * 300, "1" + "0" * 254, "1" + "0" * 255, "scan", "scan=",
           "_", ".", "Z", "z", "é", "ü", "中", "\U0001F600", "a\x00b", ""]


def _ids(rng, n):
    """``n`` ids of 0 to 4 pieces (empty, digits only, text only and
    mixed), a fifth of them exact copies of others."""
    ids = ["".join(rng.choice(_PIECES, size=int(rng.integers(0, 5))))
           for _ in range(n)]
    for i in rng.choice(n, size=n // 5, replace=False):
        ids[i] = ids[int(rng.integers(n))]
    return ids


def _jax_order(ids: np.ndarray) -> list:
    """The JAX package's native order of ``ids`` with an empty second
    column, as its export sorts a tie group's ids."""
    return j_native.natsort_pairs(ids, np.zeros(len(ids), "U1")).tolist()


@pytest.mark.parametrize("threads", [1, 2, 3, 8])
@pytest.mark.parametrize("n", [3_000, 20_000])  # the cutoff is 16,384 rows
def test_natsort_rows_matches_the_jax_order(monkeypatch, threads, n):
    """Over columns of several widths, on one thread and on several,
    below and above the rows where threads start: the stable order of the
    JAX package's ``natsort_key`` and the order of its native sort."""
    monkeypatch.setenv("FALCON_TPU_EXPORT_THREADS", str(threads))
    rng = np.random.default_rng(n + threads)
    ids = _ids(rng, n)
    cuts = [0, *sorted(rng.choice(np.arange(1, n), 3, replace=False)), n]
    cols = [np.asarray(ids[a:b]) for a, b in zip(cuts, cuts[1:])]
    assert len({c.dtype for c in cols}) > 1
    got = t_native.natsort_rows(cols).tolist()
    assert got == sorted(range(n), key=lambda i: natsort_key(ids[i]))
    assert got == _jax_order(np.concatenate(cols))


@pytest.mark.parametrize("threads", [1, 8])
def test_natsort_rows_code_points_past_unicode(monkeypatch, threads):
    """UTF-32 slots may hold any 32-bit value: code points at each UTF-8
    length's edges and past U+10FFFF and U+1FFFFF order as the JAX
    package's native sort orders them."""
    monkeypatch.setenv("FALCON_TPU_EXPORT_THREADS", str(threads))
    points = [0x01, 0x7F, 0x80, 0x7FF, 0x800, 0xFFFF, 0x10000, 0x10FFFF,
              0x110000, 0x1FFFFF, 0x200000, 0xFFFFFFFF, ord("5"), 0]
    rng = np.random.default_rng(3)
    slots = rng.choice(points, size=(20_000, 4)).astype(np.uint32)
    slots[:, 0] = np.where(slots[:, 0] == 0, 1, slots[:, 0])
    ids = slots.view("U4").ravel()
    got = t_native.natsort_rows([ids[:200], ids[200:]])
    assert got.tolist() == _jax_order(ids)


def test_natsort_rows_declines_what_it_cannot_read():
    """A column that is not a numpy U column (a list, bytes, objects, a
    big-endian U column) leaves the sort to the caller's fallback."""
    ids = np.asarray(["b2", "a10"])
    assert t_native.natsort_rows([ids]).tolist() == [1, 0]
    for col in (["b2", "a10"], ids.astype("S3"), ids.astype(object),
                ids.astype(">U3")):
        assert t_native.natsort_rows([ids, col]) is None
