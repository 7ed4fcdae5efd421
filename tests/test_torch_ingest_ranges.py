"""The port's ranged ingest of one MGF or MSP file against the JAX
package's, and its native top-N peak selection against the stable-sort
rule, on the CPU.

A file larger than the range threshold is parsed as byte ranges on threads
(``ingest._ingest_ranges``), a smaller one or a budget of one as one
range, and its shards are planned from the ranges' row counts and written
concurrently (``store.RunPlan``).  Every shard's name and every ``.npy``
byte must equal what the JAX package's ``ingest_file_to_store`` writes
from the same file, for several range budgets and shard sizes.
"""

import ctypes
import math
import os

import numpy as np
import pytest

import falcon_tpu.ingest as j_ingest
import falcon_tpu.store.store as j_store

import falcon_tpu_torch.ingest as t_ingest
import falcon_tpu_torch.native as t_native
import falcon_tpu_torch.store.store as t_store
from falcon_tpu_torch.preprocess.spectrum import _filter_intensity_mask
from falcon_tpu_torch.utils.profiling import profiler

PROCESS = dict(min_peaks=5, min_mz_range=250.0, mz_min=101.0, mz_max=1500.0,
               remove_precursor_tolerance=1.5, min_intensity=0.01,
               max_peaks_used=50, scaling=None)


def _peak_lines(rng, n, crlf=False, ties=False):
    """``n`` peak lines in m/z order, in the spellings an MGF file holds."""
    mz = np.sort(rng.uniform(110.0, 1450.0, n))
    if ties:
        # Few distinct intensities, so the 50-peak cut falls inside a tie.
        inten = rng.integers(1, 6, n).astype(float) * 10.0
    else:
        inten = rng.uniform(0.5, 100.0, n)
    end = "\r\n" if crlf else "\n"
    lines = []
    for k, (m, i) in enumerate(zip(mz, inten)):
        if k % 17 == 3:
            lines.append(f"{m:.5f}\t{i:.3f}  {end}")
        elif k % 23 == 5:
            lines.append(f"  {m:.4f} {i:.6e}{end}")
        elif k % 29 == 7:
            lines.append(f"+{m:.3f} {i:.2f} annotation{end}")
        elif k % 31 == 11:
            lines.append(f"{m:.17f} {i:.19f}{end}")
        else:
            lines.append(f"{m:.5f} {i:.6f}{end}")
    return "".join(lines)


def _mgf_bytes(seed: int) -> bytes:
    """An MGF file of many layouts: a header with params, spectra over and
    under 50 peaks with ties at the cut, CRLF endings, comments, malformed
    and one-token peak lines, NaN and infinite peaks, missing and negative
    charges, titles of many lengths in non-ASCII UTF-8 and one that is not
    UTF-8, and one spectrum long enough to hold whole ranges."""
    rng = np.random.default_rng(seed)
    out = [b"# generated\nCOM=ranged ingest test\nCHARGE=2+\n\n"]
    names = ["x", "spectrum_été", "日本語_scan",
             "probe \U0001f9ea", "a" * 61, "plain"]
    for s in range(90):
        crlf = s % 7 == 3
        end = "\r\n" if crlf else "\n"
        title = f"{names[s % len(names)]}_{s}"
        head = [f"BEGIN IONS{end}"]
        if s % 11 == 4:
            head.append(f"; comment inside a block{end}")
        head.append(f"TITLE={title}{end}")
        head.append(f"PEPMASS={rng.uniform(400, 1200):.7f} 1234.5{end}")
        if s % 9 != 2:  # else the header's CHARGE=2+ applies
            head.append(f"CHARGE={(2, 3, 4, 1)[s % 4]}"
                        f"{'-' if s % 13 == 6 else '+'}{end}")
        head.append(f"RTINSECONDS={rng.uniform(0, 3600):.3f}{end}")
        n = 3000 if s == 40 else int(rng.integers(20, 90))
        body = _peak_lines(rng, n, crlf=crlf, ties=s % 3 == 0)
        if s % 10 == 1:
            body += f"nan 5.0{end}300.25 inf{end}-inf 2{end}"
        if s % 15 == 8:
            body += f"abc def{end}"  # malformed: the spectrum is skipped
        if s % 12 == 5:
            body += f"512.5{end}"  # one token: the line is skipped
        block = "".join(head).encode() + body.encode()
        if s == 57:
            block = block.replace(title.encode(), b"bad\xff\xfetitle")
        out.append(block + f"END IONS{end}{end}".encode())
    return b"".join(out)


def _msp_bytes(seed: int) -> bytes:
    """An MSP library of many layouts: precursors from PrecursorMZ, a
    Comment's Parent or MW, charges in three spellings, ';'-packed and
    annotated peaks, entries over and under 50 peaks, comments, stray
    headers inside a peak list, names in non-ASCII UTF-8 and one that is
    not UTF-8, and one entry long enough to hold whole ranges."""
    rng = np.random.default_rng(seed)
    out = []
    for s in range(70):
        lines = ["# library comment"] if s % 8 == 1 else []
        lines.append(f"Name: {('entrée', 'plain', 'b' * 40)[s % 3]} {s}")
        pep = 400.0 + 11.0 * s
        lines.append((f"PrecursorMZ: {pep:.4f}",
                      f"Comment: Spec=x Parent={pep:.4f} X=1",
                      f"MW: {pep:.4f}")[s % 3])
        lines.append(("Charge: 2+", "Charge: 3", 'Comment: Charge=2 N="a b"',
                      "")[s % 4])
        lines.append(f"Comment: RTINSECONDS={rng.random() * 90:.3f}")
        lines.append("Num Peaks: irrelevant")
        n = 3000 if s == 33 else int(rng.integers(20, 90))
        mzs = np.sort(rng.uniform(110.0, 1450.0, n))
        ints = (rng.integers(1, 6, n) * 10.0 if s % 3 == 0
                else rng.uniform(0.5, 100.0, n))
        k = 0
        while k < n:
            if k % 5 == 2 and k + 1 < n:
                lines.append(f"{mzs[k]:.4f} {ints[k]:.4f}; "
                             f"{mzs[k + 1]:.4f} {ints[k + 1]:.4f}")
                k += 2
            else:
                extra = ' "y1 ann"' if k % 7 == 3 else ""
                lines.append(f"{mzs[k]:.4f}\t{ints[k]:.4f}{extra}")
                k += 1
        if s % 17 == 9:
            lines.append("Collision: HCD")  # the entry is malformed
        lines.append("")
        block = "\n".join(lines).encode() + b"\n"
        if s == 41:
            block = block.replace(b"Name: ", b"Name: bad\xc3\x28 ", 1)
        out.append(block)
    return b"".join(out)


def _store_files(root):
    files = {}
    for d, _, names in os.walk(root):
        for name in names:
            path = os.path.join(d, name)
            with open(path, "rb") as f:
                files[os.path.relpath(path, root)] = f.read()
    return files


def _writer_of_size(package_store, size):
    """``SpectrumStore.writer`` with every shard's batch size ``size``."""
    def writer(self, batch_size=10_000, shard_prefix=""):
        return package_store.ShardWriter(self.root, size, shard_prefix)
    return writer


@pytest.mark.parametrize("batch_size", [10_000, 7])
@pytest.mark.parametrize("budget", [1, 2, 3, 8])
@pytest.mark.parametrize("fmt", ["mgf", "msp"])
def test_ranged_ingest_writes_the_jax_packages_shards(tmp_path, monkeypatch,
                                                      fmt, budget,
                                                      batch_size):
    path = tmp_path / f"in.{fmt}"
    path.write_bytes(_mgf_bytes(seed=21) if fmt == "mgf"
                     else _msp_bytes(seed=22))
    size = os.path.getsize(path)
    for mod in (t_ingest, j_ingest):
        monkeypatch.setattr(mod, "_RANGE_MIN_BYTES", 1)
        monkeypatch.setattr(mod, "_RANGE_TARGET_BYTES", size // 64)
    for package_store in (t_store, j_store):
        monkeypatch.setattr(package_store.SpectrumStore, "writer",
                            _writer_of_size(package_store, batch_size))

    profiler.start_recording()
    try:
        got = t_ingest.ingest_file_to_store(
            str(path), 3, str(tmp_path / "t"), PROCESS, range_budget=budget)
    finally:
        profiler.stop_recording()
    want = j_ingest.ingest_file_to_store(
        str(path), 3, str(tmp_path / "j"), PROCESS, range_budget=budget)
    assert got == want
    assert got[1] > 50

    t_files = _store_files(tmp_path / "t")
    j_files = _store_files(tmp_path / "j")
    assert sorted(t_files) == sorted(j_files)
    for name, data in j_files.items():
        assert t_files[name] == data, name

    counters = profiler.counters()
    assert counters["ingest.ranges"] == budget
    assert counters["ingest.titles_fallback"] == 1
    assert counters["ingest.topn_cut"] > 0
    assert counters["ingest.spectra"] == got[1]
    assert counters["ingest.shards"] == len(
        {os.path.dirname(n) for n in t_files})
    bounds = [size * i // budget for i in range(budget + 1)]
    data = path.read_bytes()
    block = b"BEGIN IONS" if fmt == "mgf" else b"Name: "
    owners = [data.count(block, lo, hi)
              for lo, hi in zip(bounds[:-1], bounds[1:])]
    if budget == 8:
        assert 0 in owners  # a range inside the long spectrum


def _preprocess_native(mz, intensity, min_intensity, max_peaks_used):
    """``fc_preprocess_spectrum`` with only the intensity filter on."""
    lib = t_native.get_lib()
    fn = lib.fc_preprocess_spectrum
    fn.restype = ctypes.c_bool
    fn.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_double, ctypes.c_int32,
        ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_int]
    mz = np.array(mz, np.float32)
    intensity = np.array(intensity, np.float32)
    n = ctypes.c_int64(len(mz))
    nan = float("nan")
    ok = fn(mz.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            intensity.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.byref(n), 500.0, 2, 1, 0.0, nan, nan, nan,
            nan if min_intensity is None else min_intensity,
            max_peaks_used, 0)
    assert ok
    return mz[:n.value], intensity[:n.value]


def _intensities(case, rng):
    n, kind = case
    if kind == "equal":
        return np.full(n, 7.0)
    if kind == "ties":
        return rng.integers(1, 4, n).astype(float)
    if kind == "zeros":  # -0.0 and 0.0 tie, as in a float compare
        return np.where(rng.random(n) < 0.5, -0.0, 0.0) + (
            np.arange(n) % 3 == 0) * 2.0
    return rng.uniform(0.1, 10.0, n)


@pytest.mark.parametrize("max_peaks_used", [50, 1, 0, -3])
@pytest.mark.parametrize("min_intensity", [None, 0.0, 0.3])
@pytest.mark.parametrize("case", [
    (60, "equal"), (80, "ties"), (51, "ties"), (50, "ties"), (49, "random"),
    (51, "random"), (200, "random"), (64, "zeros"), (3000, "ties"),
    (3000, "random")],
    ids=lambda c: f"{c[0]}-{c[1]}" if isinstance(c, tuple) else None)
def test_top_n_selection_keeps_the_stable_sorts_tail(case, min_intensity,
                                                     max_peaks_used):
    rng = np.random.default_rng(case[0])
    intensity = _intensities(case, rng).astype(np.float32)
    mz = np.arange(len(intensity), dtype=np.float32) + 200.0
    got_mz, got_int = _preprocess_native(mz, intensity, min_intensity,
                                         max_peaks_used)
    # A cap of 0 or less is no cap (process_spectrum's None); with no
    # threshold either, the filter is off.
    max_num = len(mz) if max_peaks_used <= 0 else max_peaks_used
    keep = np.ones(len(mz), bool)
    if min_intensity is not None or max_peaks_used > 0:
        keep = _filter_intensity_mask(
            intensity, 0.0 if min_intensity is None else min_intensity,
            max_num)
    np.testing.assert_array_equal(got_mz, mz[keep])
    kept = intensity[keep].astype(np.float64)
    np.testing.assert_allclose(
        got_int, kept / math.sqrt(float((kept * kept).sum())), rtol=1e-6)
