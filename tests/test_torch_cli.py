"""The port's CLI (``python -m falcon_tpu_torch``) against the JAX
package's on the CPU: the same corpus gives the same CSV bytes (apart from
the ``# work_dir`` line) and the same representative MGF, with the exact
backend, with ``--backend ann`` (the default index, and ``brute``), with
``--backend ann --ann_index exact``, with ``--ann_index ivf``, in dbscan
mode (also on a corpus that holds copies of spectra, whose medoids tie),
under ``--rerank off`` and with consensus representatives; a work_dir
ingested by one package resumes under the other, and the port never
imports JAX.
"""

import dataclasses
import json
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from falcon_tpu import cli as jax_cli
from falcon_tpu.simulate import make_clustered_spectra, write_mgf
from falcon_tpu_torch import api, cli
from falcon_tpu_torch.cluster import ann_engine
from falcon_tpu_torch.ops import exact_knn
from falcon_tpu_torch.device import DEVICE_ENV, resolve_device

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture()
def mgf_inputs(tmp_path, monkeypatch):
    # The corpus of tests/test_cli.py.
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    spectra, _ = make_clustered_spectra(
        n_clusters=10, cluster_size=5, n_noise=15, seed=21, charges=(2, 3),
    )
    half = len(spectra) // 2
    f1 = write_mgf(str(tmp_path / "run1.mgf"), spectra[:half])
    f2 = write_mgf(str(tmp_path / "run2.mgf"), spectra[half:])
    return tmp_path, [f1, f2]


def _csv_without_work_dir(path: str) -> bytes:
    with open(path, "rb") as f:
        lines = f.readlines()
    assert any(line.startswith(b"# work_dir = ") for line in lines)
    return b"".join(line for line in lines
                    if not line.startswith(b"# work_dir = "))


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("extra", [[], ["--linkage", "average",
                                        "--min_matched_peaks", "3"]],
                         ids=["defaults", "average_min_matches"])
def test_csv_and_mgf_identical_to_jax(mgf_inputs, extra):
    tmp_path, files = mgf_inputs
    flags = ["--export_representatives"] + extra
    assert jax_cli.main(files + [str(tmp_path / "jax"), "--work_dir",
                                 str(tmp_path / "w_jax")] + flags) == 0
    assert cli.main(files + [str(tmp_path / "torch"), "--work_dir",
                             str(tmp_path / "w_torch")] + flags) == 0
    assert (_csv_without_work_dir(str(tmp_path / "torch.csv"))
            == _csv_without_work_dir(str(tmp_path / "jax.csv")))
    assert _read(str(tmp_path / "torch.mgf")) == _read(
        str(tmp_path / "jax.mgf"))


ANN = ["--backend", "ann", "--ann_index", "exact"]


@pytest.mark.parametrize("extra,group_max", [
    ([], None),
    (["--linkage", "single", "--min_matched_peaks", "3", "--rt_tol", "30"],
     None),
    (["--linkage", "average"], 4),
    (["--eps", "0.2"], 4),
], ids=["complete", "single_min_matches_rt", "average_large",
        "complete_large_pruned"])
def test_ann_exact_csv_and_mgf_identical_to_jax(mgf_inputs, monkeypatch,
                                                extra, group_max):
    # group_max 4 sends the 5-spectrum clusters' components down the
    # large-component routes: K1 under average linkage, the pruned pair
    # lists under complete linkage.
    if group_max is not None:
        monkeypatch.setenv("FALCON_TPU_LINKAGE_GROUP_MAX", str(group_max))
        monkeypatch.setattr(ann_engine, "LINKAGE_GROUP_MAX", group_max)
    tmp_path, files = mgf_inputs
    flags = ["--export_representatives"] + ANN + extra
    assert jax_cli.main(files + [str(tmp_path / "jax"), "--work_dir",
                                 str(tmp_path / "w_jax")] + flags) == 0
    assert cli.main(files + [str(tmp_path / "torch"), "--work_dir",
                             str(tmp_path / "w_torch")] + flags) == 0
    assert (_csv_without_work_dir(str(tmp_path / "torch.csv"))
            == _csv_without_work_dir(str(tmp_path / "jax.csv")))
    assert _read(str(tmp_path / "torch.mgf")) == _read(
        str(tmp_path / "jax.mgf"))


@pytest.mark.parametrize("extra,group_max", [
    ([], None),
    (["--linkage", "single", "--min_matched_peaks", "3", "--rt_tol", "30"],
     None),
    (["--linkage", "average"], 4),
    (["--ann_index", "brute", "--eps", "0.2"], 4),
], ids=["complete", "single_min_matches_rt", "average_large",
        "brute_complete_large_pruned"])
def test_default_ann_csv_and_mgf_identical_to_jax(mgf_inputs, monkeypatch,
                                                  extra, group_max):
    # --backend ann with its defaults: --ann_index auto, --rerank exact.
    if group_max is not None:
        monkeypatch.setenv("FALCON_TPU_LINKAGE_GROUP_MAX", str(group_max))
        monkeypatch.setattr(ann_engine, "LINKAGE_GROUP_MAX", group_max)
    tmp_path, files = mgf_inputs
    flags = ["--export_representatives", "--backend", "ann"] + extra
    assert jax_cli.main(files + [str(tmp_path / "jax"), "--work_dir",
                                 str(tmp_path / "w_jax")] + flags) == 0
    assert cli.main(files + [str(tmp_path / "torch"), "--work_dir",
                             str(tmp_path / "w_torch")] + flags) == 0
    assert (_csv_without_work_dir(str(tmp_path / "torch.csv"))
            == _csv_without_work_dir(str(tmp_path / "jax.csv")))
    assert _read(str(tmp_path / "torch.mgf")) == _read(
        str(tmp_path / "jax.mgf"))


def test_ann_exact_two_passes_csv_and_mgf_identical_to_jax(tmp_path,
                                                         monkeypatch):
    # ~160 charge-2 spectra in 1 m/z: a 500 ppm band spans 256 columns,
    # and a tiny panel budget makes the port cover it in two passes.
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    monkeypatch.setattr(exact_knn, "PANEL_BYTES", 1)
    spectra, _ = make_clustered_spectra(
        n_clusters=20, cluster_size=6, n_noise=40, seed=33, charges=(2,),
        precursor_mz_range=(600.0, 601.0))
    files = [write_mgf(str(tmp_path / "dense.mgf"), spectra)]
    flags = (["--export_representatives", "--precursor_tol", "500", "ppm"]
             + ANN)
    calls = []
    banded = exact_knn.banded_panel_scores

    def count(*a, **k):
        calls.append(a[6])  # the pass width
        return banded(*a, **k)

    monkeypatch.setattr(exact_knn, "banded_panel_scores", count)
    assert jax_cli.main(files + [str(tmp_path / "jax"), "--work_dir",
                                 str(tmp_path / "w_jax")] + flags) == 0
    assert cli.main(files + [str(tmp_path / "torch"), "--work_dir",
                             str(tmp_path / "w_torch")] + flags) == 0
    assert calls == [128, 128]
    assert (_csv_without_work_dir(str(tmp_path / "torch.csv"))
            == _csv_without_work_dir(str(tmp_path / "jax.csv")))
    assert _read(str(tmp_path / "torch.mgf")) == _read(
        str(tmp_path / "jax.mgf"))


def test_work_dir_resumes_across_packages(mgf_inputs, caplog):
    tmp_path, files = mgf_inputs
    work = str(tmp_path / "work")
    assert jax_cli.main(files + [str(tmp_path / "jax"), "--work_dir",
                                 work]) == 0
    cache = [os.path.join(work, "spectra", f)
             for f in os.listdir(os.path.join(work, "spectra"))]
    stamps = {p: os.stat(p).st_mtime_ns for p in cache}
    caplog.clear()
    with caplog.at_level("DEBUG", logger="falcon_tpu"):
        assert cli.main(files + [str(tmp_path / "torch"), "--work_dir",
                                 work]) == 0
    # The store was read, not rewritten: no ingest phase, files untouched.
    assert not re.search(r"phase ingest\b", caplog.text)
    assert {p: os.stat(p).st_mtime_ns for p in cache} == stamps
    assert _read(str(tmp_path / "torch.csv")) == _read(
        str(tmp_path / "jax.csv"))


def test_api_matches_jax_api(mgf_inputs):
    from falcon_tpu import api as jax_api

    tmp_path, files = mgf_inputs
    result = api.cluster(files, export_representatives=True)
    ref = jax_api.cluster(files, export_representatives=True)
    assert len(result) > 0
    for field in ("spectrum_id", "precursor_charge", "cluster"):
        assert (getattr(result, field) == getattr(ref, field)).all()
    assert ([s.identifier for s in result.representatives]
            == [s.identifier for s in ref.representatives])
    options = dict(backend="ann", rerank="off", export_representatives=True)
    result = api.cluster(files, **options)
    ref = jax_api.cluster(files, **options)
    assert (result.cluster == ref.cluster).all()
    assert ([s.identifier for s in result.representatives]
            == [s.identifier for s in ref.representatives])
    options = dict(backend="ann", ann_index="ivf", n_probe=4,
                   export_representatives=True)
    result = api.cluster(files, **options)
    ref = jax_api.cluster(files, **options)
    assert (result.cluster == ref.cluster).all()
    assert ([s.identifier for s in result.representatives]
            == [s.identifier for s in ref.representatives])


def test_api_passes_ann_options_through(mgf_inputs):
    from falcon_tpu import api as jax_api

    tmp_path, files = mgf_inputs
    options = dict(backend="ann", ann_index="exact", eps=0.2,
                   n_neighbors=8, export_representatives=True)
    result = api.cluster(files, **options)
    ref = jax_api.cluster(files, **options)
    for field in ("spectrum_id", "precursor_charge", "cluster"):
        assert (getattr(result, field) == getattr(ref, field)).all()
    assert ([s.identifier for s in result.representatives]
            == [s.identifier for s in ref.representatives])
    options.update(cluster_method="dbscan", min_samples=3,
                   representative_method="consensus")
    result = api.cluster(files, **options)
    ref = jax_api.cluster(files, **options)
    assert (result.cluster == ref.cluster).all()
    assert len(result.representatives) == len(ref.representatives) > 0
    for got, want in zip(result.representatives, ref.representatives):
        assert got.identifier == want.identifier
        assert (got.mz == want.mz).all()
        assert (got.intensity == want.intensity).all()


def test_profile_writes_a_torch_trace(mgf_inputs):
    tmp_path, files = mgf_inputs
    trace_dir = tmp_path / "trace"
    assert cli.main(files + [str(tmp_path / "out"), "--profile",
                             str(trace_dir)]) == 0
    trace = json.loads((trace_dir / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    # The program's phases are ranges of the one trace.
    assert {"ingest", "cluster charge 2", "export"} <= names


@pytest.mark.parametrize("flags", [
    [], ANN, ["--backend", "ann"],
    ["--backend", "ann", "--cluster_method", "dbscan"],
    ["--backend", "ann", "--rerank", "off", "--cluster_method", "dbscan"],
    ["--export_representatives", "--representative_method", "consensus"],
], ids=["exact", "ann_exact", "ann", "ann_dbscan", "ann_rerank_off_dbscan",
        "consensus"])
def test_no_jax_is_imported(mgf_inputs, flags):
    tmp_path, files = mgf_inputs
    script = (
        "import sys\n"
        "from falcon_tpu_torch import cli\n"
        f"rc = cli.main({files!r} + [{str(tmp_path / 'out')!r}] + "
        f"{flags!r})\n"
        "assert rc == 0, rc\n"
        "leaked = sorted(m for m in sys.modules\n"
        "                if m == 'jax' or m.startswith(('jax.', 'jaxlib')))\n"
        "print('JAX_MODULES', leaked)\n"
        "sys.exit(1 if leaked else 0)\n"
    )
    env = dict(os.environ, **{DEVICE_ENV: "cpu", "PYTHONPATH": str(REPO)})
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "JAX_MODULES []" in proc.stdout
    assert os.path.isfile(str(tmp_path / "out.csv"))


def test_no_jax_import_in_sources():
    pattern = re.compile(r"^\s*(import jax|from jax)\b", re.MULTILINE)
    sources = sorted((REPO / "falcon_tpu_torch").rglob("*.py"))
    assert sources
    offenders = [str(p) for p in sources if pattern.search(p.read_text())]
    assert offenders == []


def test_cuda_without_gpu_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is visible")
    monkeypatch.delenv(DEVICE_ENV, raising=False)
    with pytest.raises(RuntimeError, match=DEVICE_ENV):
        resolve_device()
    with pytest.raises(RuntimeError, match=DEVICE_ENV):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


CONSENSUS = ["--representative_method", "consensus"]
IVF = ["--backend", "ann", "--ann_index", "ivf"]


@pytest.mark.parametrize("flags", [
    ["--backend", "ann", "--rerank", "off"],
    CONSENSUS,
    ANN + ["--cluster_method", "dbscan"],
    ["--backend", "ann", "--ann_index", "brute", "--rerank", "off"],
    ["--backend", "ann", "--cluster_method", "dbscan"],
    ["--backend", "ann", "--rerank", "off", "--cluster_method", "dbscan"],
    ["--backend", "ann", "--cluster_method", "dbscan", "--min_samples", "3",
     "--rt_tol", "30", "--min_matched_peaks", "3"],
    ["--backend", "ann"] + CONSENSUS,
    ANN + ["--cluster_method", "dbscan"] + CONSENSUS,
    IVF,
    IVF + ["--n_probe", "4"],
    IVF + ["--cluster_method", "dbscan"],
    IVF + ["--rerank", "off"],
    IVF + CONSENSUS,
], ids=["ann", "consensus", "ann_dbscan", "ann_brute_rerank_off",
        "ann_auto_dbscan", "ann_rerank_off_dbscan",
        "ann_dbscan_min_samples_rt_min_matches", "ann_consensus",
        "ann_exact_dbscan_consensus", "ivf", "ivf_n_probe_4", "ivf_dbscan",
        "ivf_rerank_off", "ivf_consensus"])
def test_ported_options_csv_and_mgf_identical_to_jax(mgf_inputs, flags):
    # dbscan mode, --rerank off, consensus representatives and the IVF
    # index, alone and with each of them.
    tmp_path, files = mgf_inputs
    flags = ["--export_representatives"] + flags
    assert jax_cli.main(files + [str(tmp_path / "jax"), "--work_dir",
                                 str(tmp_path / "w_jax")] + flags) == 0
    assert cli.main(files + [str(tmp_path / "torch"), "--work_dir",
                             str(tmp_path / "w_torch")] + flags) == 0
    assert (_csv_without_work_dir(str(tmp_path / "torch.csv"))
            == _csv_without_work_dir(str(tmp_path / "jax.csv")))
    mgf = _read(str(tmp_path / "torch.mgf"))
    assert mgf == _read(str(tmp_path / "jax.mgf"))
    if CONSENSUS[1] in flags:
        assert b"consensus_cluster" in mgf


@pytest.mark.parametrize("index", ["auto", "exact"])
def test_dbscan_medoids_of_copies_identical_to_jax(tmp_path, monkeypatch,
                                                   index):
    # A corpus in which 24 spectra appear twice (same peaks, precursor and
    # RT, new titles): each pair of copies ties for medoid up to the last
    # bit of the exact scores, and the medoid MGF must name the JAX
    # package's copy.
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    spectra, _ = make_clustered_spectra(
        n_clusters=10, cluster_size=5, n_noise=15, seed=9, charges=(2, 3),
    )
    spectra += [dataclasses.replace(s, identifier=s.identifier + "_copy")
                for s in spectra[1::2][:24]]
    files = [write_mgf(str(tmp_path / "run.mgf"), spectra)]
    flags = ["--export_representatives", "--backend", "ann", "--ann_index",
             index, "--cluster_method", "dbscan"]
    assert jax_cli.main(files + [str(tmp_path / "jax"), "--work_dir",
                                 str(tmp_path / "w_jax")] + flags) == 0
    assert cli.main(files + [str(tmp_path / "torch"), "--work_dir",
                             str(tmp_path / "w_torch")] + flags) == 0
    assert (_csv_without_work_dir(str(tmp_path / "torch.csv"))
            == _csv_without_work_dir(str(tmp_path / "jax.csv")))
    mgf = _read(str(tmp_path / "torch.mgf"))
    assert mgf == _read(str(tmp_path / "jax.mgf"))
    assert b"_copy" in _read(str(tmp_path / "torch.csv"))


@pytest.mark.parametrize("flags", [
    IVF + ["--cluster_method", "dbscan", "--rerank", "off", "--n_probe", "4",
           "--rt_tol", "30", "--min_matched_peaks", "3"],
], ids=["ann_ivf"])
def test_unported_options_exit_1(mgf_inputs, flags, caplog):
    # The port once refused --ann_index ivf with exit code 1; it runs now,
    # logs no refusal and writes the JAX package's CSV.
    tmp_path, files = mgf_inputs
    assert jax_cli.main(files + [str(tmp_path / "jax"), "--work_dir",
                                 str(tmp_path / "w_jax")] + flags) == 0
    with caplog.at_level("ERROR", logger="falcon_tpu"):
        assert cli.main(files + [str(tmp_path / "torch"), "--work_dir",
                                 str(tmp_path / "w_torch")] + flags) == 0
    assert "not yet ported" not in caplog.text
    assert (_csv_without_work_dir(str(tmp_path / "torch.csv"))
            == _csv_without_work_dir(str(tmp_path / "jax.csv")))
