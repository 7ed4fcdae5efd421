"""The port's CSV export (``falcon_tpu_torch/export.py``) held to the JAX
package's export byte for byte, and its native rows
(``native.export_rows``) to ``csv.writer``."""

import gc
import os
import resource

import numpy as np
import pytest

import falcon_tpu.store.store as j_store
import falcon_tpu_torch.export as t_export
import falcon_tpu_torch.store.store as t_store
from falcon_tpu.export import export_cluster_csv as j_export_cluster_csv
from falcon_tpu_torch import native as t_native
from torch_cases import EXPORT_TIE_CHARGES, csv_writer_rows, export_tie_store

NULL = -(2 ** 15)


def _header(f):
    f.write("# hdr\n")


def _entries(store, labels):
    return [(store.dataset(c), lab)
            for c, lab in zip(EXPORT_TIE_CHARGES, labels)]


def _jax_bytes(tmp_path, root, labels):
    path = tmp_path / "jax.csv"
    j_export_cluster_csv(str(path), _header,
                         _entries(j_store.SpectrumStore(root), labels))
    return path.read_bytes()


def _port_bytes(tmp_path, store, labels):
    path = tmp_path / "port.csv"
    n = t_export.export_cluster_csv(str(path), _header,
                                    _entries(store, labels))
    data = path.read_bytes()
    assert data.count(b"\n") == n + 2
    return data


@pytest.mark.parametrize("route", ["native", "format_fallback",
                                   "no_library"])
@pytest.mark.parametrize("chunk_rows", [1 << 21, 7])
def test_export_tied_names_and_mixed_shards(tmp_path, monkeypatch, route,
                                            chunk_rows):
    """A store with tied file names, a multi-file shard run, duplicate
    and leading-zero ids and the null charge exports the JAX package's
    bytes: through the native sort and rows, through the native sort and
    csv.writer, and with no native library at all; with the tie group
    whole or in chunks of 7 rows."""
    root = str(tmp_path / "store")
    store, labels = export_tie_store(root, t_store)
    want = _jax_bytes(tmp_path, root, labels)
    assert want.count(b"\n") == 2 + sum(len(lab) for lab in labels)
    if route != "native":
        monkeypatch.setattr(t_native, "export_rows", lambda *a, **k: None)
    if route == "no_library":
        monkeypatch.setattr(t_native, "natsort_rows", lambda *a, **k: None)
    monkeypatch.setattr(t_export, "_CSV_CHUNK_ROWS", chunk_rows)
    assert _port_bytes(tmp_path, store, labels) == want


@pytest.mark.parametrize("threads", [3, 8])
@pytest.mark.parametrize("chunk_rows", [1 << 21, 5_000])
def test_export_large_tie_group_on_threads(tmp_path, monkeypatch, threads,
                                           chunk_rows):
    """A tie group of 30,000 rows, past the 16,384 rows where the sort
    and the rows start threads, in shards of 2,000 rows a charge, with
    the threads forced: the JAX package's bytes."""
    monkeypatch.setenv("FALCON_TPU_EXPORT_THREADS", str(threads))
    monkeypatch.setattr(t_export, "_CSV_CHUNK_ROWS", chunk_rows)
    root = str(tmp_path / "store")
    store, labels = export_tie_store(root, t_store, seed=5, rows=12_000,
                                     batch_size=2_000)
    want = _jax_bytes(tmp_path, root, labels)
    assert want.count(b"\n") == 2 + 36_000
    assert _port_bytes(tmp_path, store, labels) == want


def test_export_holds_no_file_open_per_shard(tmp_path):
    """A tie group of 150 shards exports under an open-file limit of 40
    descriptors more than the process holds: a column's map keeps no
    descriptor.  And the maps are gone once the export has returned."""
    root = str(tmp_path / "store")
    store = t_store.SpectrumStore(root)
    writer = store.writer(batch_size=4)
    writer.add_many({"identifier": f"scan={i}", "filename": "one.mgf",
                     "precursor_mz": 500.0 + i, "precursor_charge": 2,
                     "retention_time": float(i),
                     "mz": np.asarray([110.0, 220.0], np.float32),
                     "intensity": np.ones(2, np.float32)}
                    for i in range(600))
    writer.close()
    store.save_charges([2])
    ds = store.dataset(2)
    assert len(ds.shards) == 150
    labels = np.arange(600, dtype=np.int64)
    assert t_native.get_lib() is not None
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    limit = len(os.listdir("/proc/self/fd")) + 40
    maps = _n_maps()
    resource.setrlimit(resource.RLIMIT_NOFILE, (limit, hard))
    try:
        n = t_export.export_cluster_csv(str(tmp_path / "out.csv"), _header,
                                        [(ds, labels)])
    finally:
        resource.setrlimit(resource.RLIMIT_NOFILE, (soft, hard))
    assert n == 600
    gc.collect()
    assert _n_maps() < maps + 100  # 600 columns were mapped


def _n_maps() -> int:
    with open("/proc/self/maps") as f:
        return sum(1 for _ in f)


@pytest.mark.parametrize("case", ["U34", "int16", "float32", "empty",
                                  "version_2", "two_dim", "truncated"])
def test_load_gives_what_np_load_gives(tmp_path, case):
    """The export maps a shard's column itself; it reads what ``np.load``
    reads, read-only, for each column dtype, an empty column, a version
    2.0 file, and a shape and a short file it leaves to ``np.load``."""
    rng = np.random.default_rng(5)
    arr = {"U34": np.array([f"/data/run_{i:03d}/x.mgf" for i in range(9)]),
           "int16": rng.integers(-5, 5, 11).astype(np.int16),
           "float32": rng.random(13).astype(np.float32),
           "empty": np.zeros(0, "U5"),
           "version_2": np.arange(7, dtype=np.int64),
           "two_dim": rng.random((3, 4)).astype(np.float32),
           "truncated": np.arange(5, dtype=np.int64)}[case]
    path = tmp_path / "col.npy"
    with open(path, "wb") as f:
        np.lib.format.write_array(
            f, arr, version=(2, 0) if case == "version_2" else None)
    if case == "truncated":
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) - 8)
        with pytest.raises(ValueError):
            t_export._load(str(tmp_path), "col")
        return
    got = t_export._load(str(tmp_path), "col")
    assert got.dtype == arr.dtype and got.shape == arr.shape
    np.testing.assert_array_equal(got, arr)
    assert not got.flags.writeable or case in ("empty", "two_dim")


def _rows(tmp_path, visits, order=None):
    """The bytes ``native.export_rows`` writes."""
    n = sum(len(v[1]) for v in visits)
    path = tmp_path / "rows.csv"
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
    try:
        written = t_native.export_rows(
            fd, np.arange(n) if order is None else order, visits, NULL,
            1 << 21)
    finally:
        os.close(fd)
    data = path.read_bytes()
    assert written == len(data)
    return data


def test_export_rows_parity_adversarial(tmp_path):
    """The rows == csv.writer on quoting edge cases, unicode (the astral
    plane too), the null charge and float specials, with the file name as
    a column and as one name for every row, and the rows in an order of
    their own."""
    fns = np.asarray(["plain.mzML", "with,comma.mgf", 'q"uote.mgf',
                      "new\nline", "cr\rfile", "", "üñíçødé.mzML",
                      "astral_\U0001F600.mgf"])
    ids = np.asarray(["scan=1", "id,2", 'i"3', "x", "y", "z", "idé",
                      "\U0001F600"])
    charges = np.asarray([2, 3, NULL, 0, 5, 2, 3, 1], np.int16)
    mzs = np.asarray([123.456, 1e16, 9999999999999998.0, 1e-4, 1e-5,
                      -0.0, 0.1, 1500.0])
    rts = np.asarray([float("nan"), float("inf"), float("-inf"), -1.0,
                      5400.0, 0.0, 2.5, 60.0], np.float32)
    cls = np.asarray([0, -1, 99999999, 5, 6, 7,
                      -9223372036854775808, 12], np.int64)
    order = np.asarray([7, 0, 6, 1, 5, 2, 4, 3])
    want = csv_writer_rows(fns[order], ids[order], charges[order], NULL,
                           mzs[order], rts[order], cls[order])
    assert _rows(tmp_path, [(fns, ids, charges, mzs, rts, cls)],
                 order) == want
    for name in fns:
        want = csv_writer_rows(np.full(8, name), ids, charges, NULL, mzs,
                               rts, cls)
        assert _rows(tmp_path,
                     [(str(name), ids, charges, mzs, rts, cls)]) == want


def test_export_rows_float_repr_fuzz(tmp_path):
    """str(np.float32) / str(float) parity of the rows across full-range
    bit patterns, on the formatter's threads."""
    rng = np.random.default_rng(11)
    f32 = rng.integers(0, 2 ** 32, 30_000, dtype=np.uint32).view(np.float32)
    f32 = np.concatenate([
        f32[np.isfinite(f32)],
        rng.uniform(101.0, 1500.0, 5000).astype(np.float32),
        np.asarray([0.0, -0.0, 1e-45, -1e-45, 3.4028235e38, 1.1754944e-38,
                    1e-4, 1e16, 9.99999e15, 123.456, -1.0], np.float32)])
    n = len(f32)
    one = np.full(n, "f", dtype="U1")
    zeros = np.zeros(n, np.int64)
    got = _rows(tmp_path, [("f", one, zeros, f32, f32.astype(np.float64),
                            zeros)])
    lines = got.decode().split("\n")[:-1]
    assert len(lines) == n
    for v, line in zip(f32, lines):
        fields = line.split(",")
        assert fields[3] == str(v)              # float32 repr
        assert fields[4] == str(float(v))       # widened float64 repr
