"""The JAX package's ``FALCON_TPU_*`` switches on the port's CLI, against
the JAX package's, on the CPU.

Switches that change the result (the float32 bound scan, the IVF
quantizer's space and its ranking, unpruned linkage, the grouped-kernel
limit, the neighbour budget, charges in turn) are read by the port as the
JAX package reads them: under each one, set through the environment alone,
both CLIs write the same CSV bytes (apart from the ``# work_dir`` line) and
the same representative MGF.  The IVF cases, and the switches that only
pick a TPU route (which the port does not read), are in
``tests/test_torch_switches_index.py``.
"""

import threading

import numpy as np
import pytest

from falcon_tpu import cli as jax_cli
from falcon_tpu.ms_io.containers import Spectrum
from falcon_tpu.simulate import make_clustered_spectra, write_mgf
from falcon_tpu_torch import cli
from falcon_tpu_torch.cluster import ann_engine
from falcon_tpu_torch.device import DEVICE_ENV, VIRTUAL_DEVICES_ENV
from test_torch_cli import _csv_without_work_dir, _read, mgf_inputs  # noqa: F401

ANN = ["--backend", "ann"]
DBSCAN = ANN + ["--cluster_method", "dbscan"]
IVF = ANN + ["--ann_index", "ivf"]
OFF = ["--rerank", "off"]
DENSE = ["--precursor_tol", "500", "ppm"]


def _run(package, files, out, flags):
    out.parent.mkdir(parents=True, exist_ok=True)
    assert package.main(files + [str(out), "--work_dir",
                                 str(out) + "_work",
                                 "--export_representatives"] + flags) == 0
    return (_csv_without_work_dir(str(out) + ".csv"),
            _read(str(out) + ".mgf"))


def _same_as_jax(tmp_path, files, flags):
    """Both CLIs on ``files`` with ``flags``: equal CSV and MGF bytes."""
    got = _run(cli, files, tmp_path / "torch" / "out", flags)
    want = _run(jax_cli, files, tmp_path / "jax" / "out", flags)
    assert got[0] == want[0]
    assert got[1] == want[1]
    return got


@pytest.fixture()
def dense_inputs(tmp_path, monkeypatch):
    # 160 charge-2 spectra in 1 m/z: at 500 ppm a band holds ~60 of them.
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    spectra, _ = make_clustered_spectra(
        n_clusters=20, cluster_size=6, n_noise=40, seed=33, charges=(2,),
        precursor_mz_range=(600.0, 601.0))
    return tmp_path, [write_mgf(str(tmp_path / "dense.mgf"), spectra)]


@pytest.fixture()
def copies_inputs(tmp_path, monkeypatch):
    # tests/test_torch_cli.py's corpus with copies: 24 spectra appear twice
    # (same peaks, precursor and RT), so their exact distances tie.
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    spectra, _ = make_clustered_spectra(
        n_clusters=10, cluster_size=5, n_noise=15, seed=9, charges=(2, 3))
    spectra += [Spectrum(s.identifier + "_copy", s.precursor_mz,
                         s.precursor_charge, s.mz, s.intensity,
                         s.retention_time)
                for s in spectra[1::2][:24]]
    return tmp_path, [write_mgf(str(tmp_path / "copies.mgf"), spectra)]


def _chain_spectra(steps=(3, 3, 4, 4), n_peaks=50):
    """Five spectra of ``n_peaks`` equal peaks on a 6 m/z grid, one
    precursor; each replaces ``steps[i]`` of the last one's original peaks
    by new ones, so the distance of two of them is the replacements between
    them over ``n_peaks``: a chain whose steps are within eps = 0.1 and
    whose two-step pairs are not."""
    grid = 200.0 + 6.0 * np.arange(n_peaks + sum(steps))
    peaks = list(range(n_peaks))
    fresh, spectra = n_peaks, []
    for i in range(len(steps) + 1):
        spectra.append(Spectrum(f"chain{i}", 800.0, 2, grid[sorted(peaks)],
                                [1.0] * n_peaks, 60.0))
        if i < len(steps):
            for j in range(steps[i]):
                # Replace original peaks only, oldest replacements first.
                peaks[sum(steps[:i]) + j] = fresh
                fresh += 1
    return spectra


# id: (environment, corpus, flags).  Every switch the port reads, on one
# device and at --devices 2 (virtual shards) where the JAX package reads it
# there too.
PORTED = {
    "knn_f32_linkage": ({"FALCON_TPU_KNN_DTYPE": "f32"}, "mgf", ANN),
    "knn_f32_single_rt_min_matches": (
        {"FALCON_TPU_KNN_DTYPE": "f32"}, "mgf",
        ANN + ["--linkage", "single", "--rt_tol", "30",
               "--min_matched_peaks", "3"]),
    "knn_f32_dbscan": ({"FALCON_TPU_KNN_DTYPE": "f32"}, "mgf", DBSCAN),
    "knn_f32_dbscan_copies": ({"FALCON_TPU_KNN_DTYPE": "f32"}, "copies",
                              DBSCAN),
    "knn_f32_dense": ({"FALCON_TPU_KNN_DTYPE": "f32"}, "dense",
                      DBSCAN + DENSE),
    "ivf_coarse_plain": ({"FALCON_TPU_IVF_COARSE": "plain"}, "mgf", IVF),
    "ivf_coarse_plain_rerank_off": ({"FALCON_TPU_IVF_COARSE": "plain"},
                                    "mgf", IVF + OFF),
    "ivf_coarse_plain_dense": ({"FALCON_TPU_IVF_COARSE": "plain"}, "dense",
                               IVF + DENSE),
    "ivf_rank_cos": ({"FALCON_TPU_IVF_RANK": "cos"}, "mgf", IVF),
    "ivf_rank_cos_rerank_off": ({"FALCON_TPU_IVF_RANK": "cos"}, "mgf",
                                IVF + OFF),
    "ivf_rank_cos_dbscan_dense": ({"FALCON_TPU_IVF_RANK": "cos"}, "dense",
                                  IVF + DENSE + ["--cluster_method",
                                                 "dbscan"]),
    "ivf_plain_cos": ({"FALCON_TPU_IVF_COARSE": "plain",
                       "FALCON_TPU_IVF_RANK": "cos"}, "mgf", IVF),
    "ivf_coarse_plain_devices_2": (
        {"FALCON_TPU_IVF_COARSE": "plain", VIRTUAL_DEVICES_ENV: "2"}, "mgf",
        IVF + ["--devices", "2"]),
    "ivf_rank_cos_devices_2": (
        {"FALCON_TPU_IVF_RANK": "cos", VIRTUAL_DEVICES_ENV: "2"}, "mgf",
        IVF + ["--devices", "2"]),
    "ivf_plain_rerank_off_devices_2": (
        {"FALCON_TPU_IVF_COARSE": "plain", VIRTUAL_DEVICES_ENV: "2"}, "mgf",
        IVF + OFF + ["--devices", "2"]),
    "unpruned_single": (
        {"FALCON_TPU_LINKAGE_PRUNE": "0",
         "FALCON_TPU_LINKAGE_GROUP_MAX": "4"}, "mgf",
        ANN + ["--linkage", "single"]),
    "unpruned_complete": (
        {"FALCON_TPU_LINKAGE_PRUNE": "0",
         "FALCON_TPU_LINKAGE_GROUP_MAX": "4"}, "mgf", ANN + ["--eps", "0.2"]),
    "unpruned_single_copies": (
        {"FALCON_TPU_LINKAGE_PRUNE": "0",
         "FALCON_TPU_LINKAGE_GROUP_MAX": "4"}, "copies",
        ANN + ["--linkage", "single"]),
    "unpruned_complete_copies": (
        {"FALCON_TPU_LINKAGE_PRUNE": "0",
         "FALCON_TPU_LINKAGE_GROUP_MAX": "4"}, "copies", ANN),
    "unpruned_single_exact_index_devices_2": (
        {"FALCON_TPU_LINKAGE_PRUNE": "0", "FALCON_TPU_LINKAGE_GROUP_MAX": "4",
         VIRTUAL_DEVICES_ENV: "2"}, "mgf",
        ANN + ["--ann_index", "exact", "--linkage", "single", "--devices",
               "2"]),
    "group_max_4": ({"FALCON_TPU_LINKAGE_GROUP_MAX": "4"}, "mgf", ANN),
    "group_max_4_single_copies": ({"FALCON_TPU_LINKAGE_GROUP_MAX": "4"},
                                  "copies", ANN + ["--linkage", "single"]),
    "group_max_2_devices_2": (
        {"FALCON_TPU_LINKAGE_GROUP_MAX": "2", VIRTUAL_DEVICES_ENV: "2"},
        "mgf", ANN + ["--devices", "2"]),
    "max_neighbors_8": ({"FALCON_TPU_MAX_NEIGHBORS": "8"}, "dense",
                        ANN + DENSE + ["--n_neighbors_ann", "4"]),
    "max_neighbors_2_ivf": ({"FALCON_TPU_MAX_NEIGHBORS": "2"}, "dense",
                            IVF + DENSE + ["--n_neighbors_ann", "2",
                                           "--n_neighbors", "2"]),
    "no_charge_overlap": ({"FALCON_TPU_NO_CHARGE_OVERLAP": "1"}, "mgf",
                          ANN),
    "sync_stages": ({"FALCON_TPU_SYNC_STAGES": "1"}, "mgf", DBSCAN),
}


def check_ported_switch(case, request, monkeypatch, caplog):
    """Case ``case`` of ``PORTED``: both CLIs under its environment."""
    env, corpus, flags = PORTED[case]
    tmp_path, files = request.getfixturevalue(
        {"mgf": "mgf_inputs", "dense": "dense_inputs",
         "copies": "copies_inputs"}[corpus])
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    with caplog.at_level("WARNING", logger="falcon_tpu"):
        _same_as_jax(tmp_path, files, flags)
    if case.startswith("max_neighbors"):
        # The budget is below the band: both packages warn.
        assert caplog.text.count("than the neighbor budget") >= 2
    if "devices" in case:
        assert "falling back" not in caplog.text
        assert "visible" not in caplog.text


# The IVF cases run in tests/test_torch_switches_index.py.
@pytest.mark.parametrize("case", sorted(c for c in PORTED
                                        if not c.startswith("ivf")))
def test_ported_switch_identical_to_jax(case, request, monkeypatch, caplog):
    check_ported_switch(case, request, monkeypatch, caplog)


@pytest.mark.parametrize("linkage", ["single", "complete"])
def test_unpruned_linkage_medoid(tmp_path, monkeypatch, linkage):
    # A chain of five spectra (one eps-component, large at GROUP_MAX 4):
    # single linkage keeps it whole, and its medoid is the middle spectrum
    # on the exact distances but the second one when the pruned distances
    # above eps read 1.0.  At 16,384 hashed dimensions no two of these
    # peaks share one, so the spread bound equals the exact score and
    # every pair above eps is pruned.  Complete linkage's clusters hold no
    # distance above eps, so their medoids do not depend on the pruning.
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    monkeypatch.setenv("FALCON_TPU_LINKAGE_GROUP_MAX", "4")
    files = [write_mgf(str(tmp_path / "chain.mgf"), _chain_spectra())]
    flags = ANN + ["--linkage", linkage, "--low_dim", "16384"]
    mgf = {}
    for prune in ("1", "0"):
        monkeypatch.setenv("FALCON_TPU_LINKAGE_PRUNE", prune)
        csv, mgf[prune] = _same_as_jax(tmp_path / prune, files, flags)
    if linkage == "single":
        assert b"TITLE=chain1" in mgf["1"] and b"TITLE=chain2" in mgf["0"]
        assert mgf["1"] != mgf["0"]
    else:
        assert mgf["1"] == mgf["0"]


def test_no_charge_overlap_runs_charges_in_turn(mgf_inputs, monkeypatch):
    tmp_path, files = mgf_inputs
    threads = []
    generate = cli._generate_for_charge

    def spy(*args, **kw):
        threads.append(threading.current_thread() is threading.main_thread())
        return generate(*args, **kw)

    monkeypatch.setattr(cli, "_generate_for_charge", spy)
    _run(cli, files, tmp_path / "overlap" / "out", ANN)
    assert threads == [False, False]
    threads.clear()
    monkeypatch.setenv("FALCON_TPU_NO_CHARGE_OVERLAP", "1")
    _run(cli, files, tmp_path / "serial" / "out", ANN)
    assert threads == [True, True]


def test_switch_readers_follow_the_environment(monkeypatch):
    # Each switch is read per call, with the JAX package's default.
    readers = [
        (ann_engine.scan_bf16, "FALCON_TPU_KNN_DTYPE", True, "f32", False),
        (ann_engine.linkage_prune, "FALCON_TPU_LINKAGE_PRUNE", True, "0",
         False),
        (ann_engine.ivf_coarse_spread, "FALCON_TPU_IVF_COARSE", True,
         "plain", False),
        (ann_engine.ivf_rank_ub, "FALCON_TPU_IVF_RANK", True, "cos", False),
        (ann_engine.linkage_group_max, "FALCON_TPU_LINKAGE_GROUP_MAX", 1024,
         "7", 7),
        (ann_engine.max_neighbors, "FALCON_TPU_MAX_NEIGHBORS", 1024, "16",
         16),
    ]
    for read, key, default, value, switched in readers:
        monkeypatch.delenv(key, raising=False)
        assert read() == default, key
        monkeypatch.setenv(key, value)
        assert read() == switched, key
    assert ann_engine.LINKAGE_GROUP_MAX == ann_engine.MAX_NEIGHBORS == 1024
