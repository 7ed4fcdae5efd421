"""The port's copies of the JAX package's host modules against the
originals, on the CPU.

``falcon_tpu_torch`` imports nothing of ``falcon_tpu``: it carries its own
copies of the readers, preprocessing, store, ingest, interval splits,
post-processing, hashing tables, native library, export, configuration,
metrics and the IVF index's host layout.  Each case runs one piece through
both packages on the same inputs, made from a seed, and requires equal
results (bytes, for the CSV).
"""

import base64
import os

import numpy as np
import pytest

import __graft_entry__ as j_graft
import falcon_tpu.api as j_api
import falcon_tpu.cli as j_cli
import falcon_tpu.cluster.ann_engine as j_ann
import falcon_tpu.cluster.intervals as j_intervals
import falcon_tpu.cluster.oracle as j_oracle
import falcon_tpu.cluster.postprocess as j_post
import falcon_tpu.export as j_export
import falcon_tpu.ingest as j_ingest
import falcon_tpu.metrics as j_metrics
import falcon_tpu.ms_io.ms_io as j_ms_io
import falcon_tpu.native as j_native
import falcon_tpu.ops.hashing as j_hashing
import falcon_tpu.ops.ivf as j_ivf
import falcon_tpu.parallel.sharded_exact as j_sharded_exact
import falcon_tpu.preprocess as j_prep
import falcon_tpu.store.store as j_store
import falcon_tpu.utils.natsort as j_natsort
from falcon_tpu.config import config as j_config
from falcon_tpu.ops.density import labels_from_parts as j_labels_from_parts
from falcon_tpu.simulate import make_clustered_spectra, write_mgf, write_mzml

import falcon_tpu_torch.api as t_api
import falcon_tpu_torch.cli as t_cli
import falcon_tpu_torch.cluster.ann_engine as t_ann
import falcon_tpu_torch.cluster.intervals as t_intervals
import falcon_tpu_torch.cluster.oracle as t_oracle
import falcon_tpu_torch.cluster.postprocess as t_post
import falcon_tpu_torch.export as t_export
import falcon_tpu_torch.ingest as t_ingest
import falcon_tpu_torch.metrics as t_metrics
import falcon_tpu_torch.ms_io.ms_io as t_ms_io
import falcon_tpu_torch.native as t_native
import falcon_tpu_torch.ops.hashing as t_hashing
import falcon_tpu_torch.graft_entry as t_graft
import falcon_tpu_torch.ops.ivf as t_ivf
import falcon_tpu_torch.parallel.sharded_exact as t_sharded_exact
import falcon_tpu_torch.preprocess as t_prep
import falcon_tpu_torch.simulate as t_simulate
import falcon_tpu_torch.store.store as t_store
import falcon_tpu_torch.utils.natsort as t_natsort
from falcon_tpu_torch.config import config as t_config
from falcon_tpu_torch.ops.density import labels_from_parts as t_labels
from torch_cases import EXPORT_TIE_CHARGES, export_tie_store

PROCESS = dict(min_peaks=5, min_mz_range=250.0, mz_min=101.0, mz_max=1500.0,
               remove_precursor_tolerance=1.5, min_intensity=0.01,
               max_peaks_used=50, scaling=None)


@pytest.fixture(scope="module")
def spectra():
    spectra, _ = make_clustered_spectra(n_clusters=8, cluster_size=4,
                                        n_noise=12, seed=5)
    return spectra


def _same_spectra(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for attr in ("identifier", "precursor_mz", "precursor_charge",
                     "retention_time", "filename"):
            assert getattr(g, attr) == getattr(w, attr)
        np.testing.assert_array_equal(g.mz, w.mz)
        np.testing.assert_array_equal(g.intensity, w.intensity)


def _same_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert sorted(g) == sorted(w)
            for key in g:
                np.testing.assert_array_equal(g[key], w[key])


def _mzxml(spectra) -> str:
    chunks = ['<?xml version="1.0" encoding="ISO-8859-1"?>',
              '<mzXML xmlns="http://sashimi.sourceforge.net/schema_revision'
              '/mzXML_3.2">', "<msRun>"]
    for num, s in enumerate(spectra, 1):
        pairs = np.empty(2 * len(s.mz), np.float32)
        pairs[0::2], pairs[1::2] = s.mz, s.intensity
        payload = base64.b64encode(pairs.astype(">f4").tobytes()).decode()
        chunks.append(
            f'<scan num="{num}" msLevel="2" retentionTime="PT'
            f'{s.retention_time}S" peaksCount="{len(s.mz)}">'
            f'<precursorMz precursorCharge="{s.precursor_charge}">'
            f'{s.precursor_mz}</precursorMz><peaks precision="32" '
            'byteOrder="network" contentType="m/z-int" '
            f'compressionType="none">{payload}</peaks></scan>')
    chunks.append("</msRun></mzXML>")
    return "\n".join(chunks)


def case_reader_mgf(tmp_path, spectra):
    path = write_mgf(str(tmp_path / "a.mgf"), spectra)
    _same_spectra(list(t_ms_io.get_spectra(path)),
                  list(j_ms_io.get_spectra(path)))


def case_reader_mzml(tmp_path, spectra):
    path = write_mzml(str(tmp_path / "a.mzML"), spectra)
    _same_spectra(list(t_ms_io.get_spectra(path)),
                  list(j_ms_io.get_spectra(path)))


def case_reader_mzxml(tmp_path, spectra):
    path = tmp_path / "a.mzXML"
    path.write_text(_mzxml(spectra))
    _same_spectra(list(t_ms_io.get_spectra(str(path))),
                  list(j_ms_io.get_spectra(str(path))))


def case_simulate(tmp_path, spectra):
    got, labels = t_simulate.make_clustered_spectra(
        n_clusters=8, cluster_size=4, n_noise=12, seed=5)
    _same_spectra(got, spectra)
    assert len(labels) == len(spectra)


def case_process_spectrum(tmp_path, spectra):
    for scaling in (None, "root", "log", "rank"):
        kwargs = dict(PROCESS, scaling=scaling)
        _same_rows([t_prep.process_spectrum(s, **kwargs) for s in spectra],
                   [j_prep.process_spectrum(s, **kwargs) for s in spectra])
    assert t_prep.get_dim(101.0, 1500.0, 0.05) == j_prep.get_dim(
        101.0, 1500.0, 0.05)


def case_padded_peaks(tmp_path, spectra):
    rng = np.random.default_rng(3)
    counts = rng.integers(0, 65, 40)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    mz = rng.uniform(100, 1500, offsets[-1]).astype(np.float32)
    intensity = rng.uniform(0, 1, offsets[-1]).astype(np.float32)
    for rows in (None, rng.permutation(40)[:25]):
        got = t_store.padded_peaks(offsets, mz, intensity, 64, rows)
        want = j_store.padded_peaks(offsets, mz, intensity, 64, rows)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def case_precursor_mz_splits(tmp_path, spectra):
    rng = np.random.default_rng(4)
    # Rounded to 1e-3, so neighbours tie and tolerance 0 Da splits only
    # where they differ.
    mzs = np.sort(np.round(rng.uniform(400, 402, 3000), 3))
    for tol, mode, batch in ((20.0, "ppm", 2**15), (20.0, "ppm", 64),
                             (0.01, "Da", 100), (0.0, "Da", 2**15)):
        np.testing.assert_array_equal(
            t_intervals.precursor_mz_splits(mzs, tol, mode, batch),
            j_intervals.precursor_mz_splits(mzs, tol, mode, batch))


def case_postprocess(tmp_path, spectra):
    rng = np.random.default_rng(6)
    n = 60
    labels = np.sort(rng.integers(-1, 8, n))
    mzs = rng.uniform(500, 500.05, n)
    rts = rng.uniform(0, 100, n)
    assert (list(t_post.cluster_group_slices(labels))
            == list(j_post.cluster_group_slices(labels)))
    for rt_tol in (None, 30.0):
        got, want = labels.copy(), labels.copy()
        for start, stop in j_post.cluster_group_slices(labels):
            args = (mzs[start:stop], rts[start:stop], 10.0, "ppm", rt_tol,
                    2, 100)
            assert (t_post.postprocess_cluster(got[start:stop], *args)
                    == j_post.postprocess_cluster(want[start:stop], *args))
        np.testing.assert_array_equal(got, want)
    pdist = rng.uniform(0, 1, n * (n - 1) // 2).astype(np.float32)
    order = rng.permutation(n)
    idx = np.arange(100, 100 + n)
    np.testing.assert_array_equal(
        t_post.cluster_medoids(idx, labels, pdist, order),
        j_post.cluster_medoids(idx, labels, pdist, order))
    splits = np.array([0, 20, 45, n])
    got, want = labels.copy(), labels.copy()
    assert (t_post.assign_global_cluster_labels(got, order, splits, 7)
            == j_post.assign_global_cluster_labels(want, order, splits, 7))
    np.testing.assert_array_equal(got, want)


def case_refine_and_medoids(tmp_path, spectra):
    # dbscan mode's host tail: clusters inside and outside the precursor /
    # RT span, demotion below min_samples, and quantised scores, so the
    # medoid's first-maximum-by-row tie-break decides.
    class Timer:
        def stage(self, name):
            pass

    rng = np.random.default_rng(11)
    n = 400
    labels = rng.integers(-1, 60, n)
    mzs = np.sort(rng.uniform(500.0, 500.2, n))
    rts = rng.uniform(0.0, 200.0, n)
    order = rng.permutation(n)
    scores = rng.choice(np.float32([0.5, 0.75, 1.0]), n)
    seen = []

    def score_fn(seg, n_seg):
        seen.append((seg.copy(), n_seg))
        return scores

    for rt_tol, min_samples in ((None, 2), (50.0, 3), (None, 5)):
        args = (labels, order, mzs, rts, n, 100.0, "ppm", rt_tol,
                min_samples, score_fn)
        got = t_ann._refine_and_medoids(*args)
        want = j_ann._refine_and_medoids(Timer(), *args)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(seen[-1][0], seen[-2][0])
        assert seen[-1][1] == seen[-2][1]


def case_hashing(tmp_path, spectra):
    keys = np.random.default_rng(7).integers(0, 2**31, 5000)
    np.testing.assert_array_equal(t_hashing.murmurhash3_32(keys, 3),
                                  j_hashing.murmurhash3_32(keys, 3))
    dims = t_hashing.binning_dims(101.0, 1500.0, 0.05)
    assert dims == j_hashing.binning_dims(101.0, 1500.0, 0.05)
    for low_dim, seed in ((400, 0), (128, 9)):
        np.testing.assert_array_equal(
            t_hashing.hash_bin_mapping(dims[0], low_dim, seed),
            j_hashing.hash_bin_mapping(dims[0], low_dim, seed))


def case_ivf_balanced_placement(tmp_path, spectra):
    # Skewed choices that fill lists and spill, and uniform ones.
    rng = np.random.default_rng(12)
    for n, n_lists, k, cap in ((3000, 16, 8, 256), (700, 8, 3, 128),
                               (50, 4, 2, 16)):
        skew = rng.zipf(1.5, (n, k)) % n_lists
        uniform = np.stack([rng.permutation(n_lists)[:k] for _ in range(n)])
        for choices in (skew, uniform):
            for g, w in zip(t_ivf._balanced_placement(choices, n_lists, cap),
                            j_ivf._balanced_placement(choices, n_lists, cap)):
                np.testing.assert_array_equal(g, w)


def case_ivf_bucket(tmp_path, spectra):
    for n in (0, 1, 127, 128, 129, 1000, 2**20 + 1):
        for minimum in (16, 128, 512, 1024):
            assert (t_ivf._bucket(n, minimum)
                    == j_ivf._bucket(n, minimum))


def case_ivf_pack_layout(tmp_path, spectra):
    rng = np.random.default_rng(13)
    for n, n_lists, lb in ((300, 8, 128), (1000, 16, 128), (40, 4, 16)):
        counts = np.bincount(rng.integers(0, n_lists, n), minlength=n_lists)
        lb = max(lb, int(counts.max()))
        order = rng.permutation(n)
        mzs = np.sort(rng.uniform(400.0, 1200.0, n))
        got = t_ivf.IVFIndex._pack_layout(order, mzs, counts, lb, n)
        want = j_ivf.IVFIndex._pack_layout(order, mzs, counts, lb, n)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def case_ivf_probe_ids(tmp_path, spectra):
    rng = np.random.default_rng(14)
    centroids = rng.normal(size=(32, 24)).astype(np.float32)
    # Duplicate centroids tie in the similarities: the stable order decides.
    centroids[5] = centroids[9]
    sims = centroids @ centroids.T
    t_index, j_index = (object.__new__(m.IVFIndex) for m in (t_ivf, j_ivf))
    for index in (t_index, j_index):
        index._centroid_sims, index._probe_cache = sims, {}
    for n_probe in (1, 4, 32, 4):
        got = t_ivf.IVFIndex._probe_ids(t_index, n_probe)
        want = j_ivf.IVFIndex._probe_ids(j_index, n_probe)
        assert got.dtype == want.dtype and got.flags.c_contiguous
        np.testing.assert_array_equal(got, want)


def case_native_linkage_fcluster(tmp_path, spectra):
    assert t_native.get_lib() is not None
    rng = np.random.default_rng(8)
    for n in (2, 3, 17, 120):
        # Quantised distances make ties, which the NN-chain must break
        # the same way in both builds.
        condensed = np.round(rng.uniform(0, 1, n * (n - 1) // 2), 2)
        for method in ("single", "complete", "average"):
            z = t_native.linkage(condensed, method)
            np.testing.assert_array_equal(
                z, j_native.linkage(condensed, method))
            for t in (0.1, 0.35):
                np.testing.assert_array_equal(t_native.fcluster(z, t, n),
                                              j_native.fcluster(z, t, n))


def case_native_connected_components(tmp_path, spectra):
    rng = np.random.default_rng(9)
    for n_nodes, n_edges in ((1, 0), (50, 30), (500, 400)):
        u = rng.integers(0, n_nodes, n_edges)
        v = rng.integers(0, n_nodes, n_edges)
        got = t_native.connected_components(u, v, n_nodes)
        want = j_native.connected_components(u, v, n_nodes)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


def _ingest(package_ingest, package_store, root, files):
    store = package_store.SpectrumStore(str(root))
    charges = package_ingest.prepare_spectra(store, files, PROCESS,
                                             max_workers=1)
    return store, charges


def case_ingest_and_store(tmp_path, spectra):
    files = [write_mgf(str(tmp_path / "a.mgf"), spectra[:20]),
             write_mzml(str(tmp_path / "b.mzML"), spectra[20:])]
    t_st, t_charges = _ingest(t_ingest, t_store, tmp_path / "t", files)
    j_st, j_charges = _ingest(j_ingest, j_store, tmp_path / "j", files)
    assert t_charges == j_charges and t_charges
    for charge in t_charges:
        got, want = t_st.dataset(charge), j_st.dataset(charge)
        for g, w in zip(got.read_peaks(), want.read_peaks()):
            np.testing.assert_array_equal(g, w)
        meta_g, meta_w = got.read_metadata(), want.read_metadata()
        assert sorted(meta_g) == sorted(meta_w)
        for key in meta_g:
            np.testing.assert_array_equal(meta_g[key], meta_w[key])


def case_export_csv(tmp_path, spectra):
    files = [write_mgf(str(tmp_path / "a.mgf"), spectra)]
    out = {}
    for name, ingest, store_mod, export in (
            ("t", t_ingest, t_store, t_export),
            ("j", j_ingest, j_store, j_export)):
        store, charges = _ingest(ingest, store_mod, tmp_path / name, files)
        entries, offset = [], 0
        for charge in charges:
            ds = store.dataset(charge)
            labels = np.arange(ds.count_rows(), dtype=np.int64) // 3
            entries.append((ds, labels + offset))
            offset += int(labels.max()) + 1
        path = str(tmp_path / f"{name}.csv")
        export.export_cluster_csv(path, lambda f: f.write("# header\n"),
                                  entries)
        with open(path, "rb") as f:
            out[name] = f.read()
    assert out["t"] == out["j"]
    assert out["t"].count(b"\n") == len(spectra) + 2


def case_export_csv_tied_names_and_mixed_shards(tmp_path, spectra):
    """Tied file names in one group, a multi-file shard run, duplicate
    and leading-zero ids and the null charge, with the group larger than
    a shrunken chunk of rows (``torch_cases.export_tie_store``)."""
    store, labels = export_tie_store(str(tmp_path / "store"), t_store)
    out = {}
    for name, store_mod, export in (("t", t_store, t_export),
                                    ("j", j_store, j_export)):
        st = store_mod.SpectrumStore(str(tmp_path / "store"))
        entries = [(st.dataset(c), lab)
                   for c, lab in zip(EXPORT_TIE_CHARGES, labels)]
        path = str(tmp_path / f"{name}.csv")
        chunk_rows = export._CSV_CHUNK_ROWS
        export._CSV_CHUNK_ROWS = 7
        try:
            export.export_cluster_csv(path, lambda f: f.write("# h\n"),
                                      entries)
        finally:
            export._CSV_CHUNK_ROWS = chunk_rows
        with open(path, "rb") as f:
            out[name] = f.read()
    assert out["t"] == out["j"]
    assert out["t"].count(b"\n") == sum(len(lab) for lab in labels) + 2


def case_config_api_and_manifest(tmp_path, spectra):
    args = ["in.mgf", str(tmp_path / "out"), "--backend", "ann",
            "--ann_index", "exact", "--eps", "0.2", "--precursor_tol", "10",
            "Da", "--export_representatives", "--linkage", "single"]
    t_config.parse(args)
    j_config.parse(args)
    names = t_api._option_names()
    assert names == j_api._option_names()
    for name in names | {"input_filenames", "output_filename"}:
        assert t_config[name] == j_config[name], name
    manifests = []
    for cli in (t_cli, j_cli):
        path = tmp_path / f"{cli.__name__}.txt"
        with open(path, "w") as f:
            cli._write_manifest(f)
        manifests.append(path.read_text())
    assert manifests[0] == manifests[1]
    rows = [dict(identifier="x", precursor_mz=500.0, precursor_charge=2,
                 mz=np.array([101.0]), intensity=np.array([1.0]),
                 retention_time=3.0, filename="a.mgf")]
    _same_spectra(t_cli._rep_spectra(rows), j_cli._rep_spectra(rows))


def case_natsort_metrics_labels(tmp_path, spectra):
    rng = np.random.default_rng(10)
    words = [f"scan{rng.integers(0, 300)}_{rng.choice(['a', 'B', ''])}"
             f"{rng.integers(0, 12)}" for _ in range(200)]
    assert t_natsort.natsorted(words) == j_natsort.natsorted(words)
    labels = rng.integers(-1, 20, 300)
    truth = rng.integers(0, 25, 300)
    for fn in ("cluster_purity", "cluster_completeness",
               "clustered_fraction"):
        args = (labels,) if fn == "clustered_fraction" else (labels, truth)
        assert getattr(t_metrics, fn)(*args) == getattr(j_metrics, fn)(*args)
    comp = rng.integers(0, 30, 300)
    core = rng.uniform(size=300) < 0.6
    attach = np.where(core, -1, rng.integers(-1, 300, 300))
    np.testing.assert_array_equal(
        t_labels(comp, core, attach, 300),
        j_labels_from_parts(comp, core, attach, 300))


def case_condensed_offsets_and_example_peaks(tmp_path, spectra):
    for n in (0, 1, 2, 7, 1000):
        np.testing.assert_array_equal(t_sharded_exact.condensed_offsets(n),
                                      j_sharded_exact.condensed_offsets(n))
    assert t_sharded_exact.MAX_N == j_sharded_exact.MAX_N
    for args in ((64, 64, 0), (48, 64, 3)):
        for g, w in zip(t_graft._example_peaks(*args),
                        j_graft._example_peaks(*args)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def case_oracle(tmp_path, spectra):
    # Verbatim: the copy's text is the original's (it imports only numpy
    # and SciPy), and both give the same scores, counts and distances.
    with open(j_oracle.__file__) as f_j, open(t_oracle.__file__) as f_t:
        assert f_t.read() == f_j.read()
    rows = [r for s in spectra
            if (r := j_prep.process_spectrum(s, **PROCESS)) is not None][:12]
    offsets = np.zeros(len(rows) + 1, np.int64)
    offsets[1:] = np.cumsum([len(r["mz"]) for r in rows])
    mz, intensity, n_peaks = j_store.padded_peaks(
        offsets, np.concatenate([r["mz"] for r in rows]),
        np.concatenate([r["intensity"] for r in rows]), 64)
    for a, b in ((0, 1), (2, 3), (4, 4)):
        assert (t_oracle.cosine_exact(mz[a], intensity[a], mz[b],
                                      intensity[b], 0.05)
                == j_oracle.cosine_exact(mz[a], intensity[a], mz[b],
                                         intensity[b], 0.05))
    for min_matches in (0, 6):
        np.testing.assert_array_equal(
            t_oracle.condensed_distances_exact(mz, intensity, n_peaks, 0.05,
                                               min_matches),
            j_oracle.condensed_distances_exact(mz, intensity, n_peaks, 0.05,
                                               min_matches))


CASES = {name[5:]: fn for name, fn in sorted(globals().items())
         if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_copy_matches_original(case, tmp_path, spectra):
    CASES[case](tmp_path, spectra)


def test_native_library_builds_outside_the_jax_tree():
    lib = t_native.get_lib()
    assert lib is not None
    path = t_native.library_path()
    assert os.path.isfile(path)
    assert os.path.dirname(path) == os.path.join(
        os.path.dirname(os.path.abspath(t_native.__file__)), "_build")
