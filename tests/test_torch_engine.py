"""The port's exact-backend engine against the JAX package's on the CPU.

``falcon_tpu_torch.cluster.engine.generate_clusters`` and
``falcon_tpu.cluster.engine.generate_clusters`` cluster the same charge
bucket; labels and medoids must be identical, through the grouped route
(intervals of 2..1024 spectra in one launch) and through the panel route
(every interval streamed in row panels), on corpora whose lowest intervals
link nothing and whose intervals are all single spectra.
"""

import numpy as np
import pytest
import torch

from falcon_tpu.cluster import engine as jax_engine
from falcon_tpu.preprocess import process_spectrum
from falcon_tpu.simulate import make_clustered_spectra
from falcon_tpu.store.store import SpectrumStore
from falcon_tpu_torch.cluster import engine
from falcon_tpu_torch.ops import pairwise


def _rows(**kwargs):
    spectra, _ = make_clustered_spectra(**kwargs)
    rows = []
    for s in spectra:
        out = process_spectrum(s, 5, 250, 101.0, 1500.0, 1.5, 0.01, 50,
                               None)
        if out is not None:
            rows.append(out)
    return rows


def _dataset(tmp_path_factory, name, **kwargs):
    rows = _rows(**kwargs)
    store = SpectrumStore(str(tmp_path_factory.mktemp(name)))
    writer = store.writer(batch_size=37)
    writer.add_many(rows)
    writer.close()
    return store.dataset(2)


@pytest.fixture(scope="module")
def dataset_fixture(tmp_path_factory):
    # The fixture of tests/test_engine.py.
    return _dataset(tmp_path_factory, "spectra", n_clusters=15,
                    cluster_size=5, n_noise=25, seed=11, charges=(2,))


@pytest.fixture(scope="module")
def dense_fixture(tmp_path_factory):
    # Precursors crowded into 0.2 m/z: four intervals of 13 to 50 spectra.
    return _dataset(tmp_path_factory, "dense", n_clusters=12,
                    cluster_size=6, n_noise=30, seed=4, charges=(2,),
                    precursor_mz_range=(600.0, 600.2))


@pytest.fixture(scope="module")
def low_noise_fixture(tmp_path_factory):
    # The two lowest intervals hold 6 and 3 unrelated spectra each, which
    # link nothing, below clusters at 500..1200 m/z.
    rows = (_rows(n_clusters=0, n_noise=6, seed=21, charges=(2,),
                  precursor_mz_range=(400.0, 400.002))
            + _rows(n_clusters=0, n_noise=3, seed=22, charges=(2,),
                    precursor_mz_range=(410.0, 410.002))
            + _rows(n_clusters=8, cluster_size=5, n_noise=10, seed=23,
                    charges=(2,), precursor_mz_range=(500.0, 1200.0)))
    store = SpectrumStore(str(tmp_path_factory.mktemp("low_noise")))
    writer = store.writer(batch_size=37)
    writer.add_many(rows)
    writer.close()
    return store.dataset(2)


@pytest.fixture(scope="module")
def singletons_fixture(tmp_path_factory):
    # Twenty unrelated spectra over 400..1200 m/z: every interval is one
    # spectrum.
    return _dataset(tmp_path_factory, "singletons", n_clusters=0,
                    n_noise=20, seed=24, charges=(2,))


@pytest.mark.parametrize("corpus,linkage,panel_only", [
    *[pytest.param("dataset_fixture", linkage, panel_only,
                   id=f"{linkage}-{route}")
      for linkage in ("complete", "single", "average")
      for route, panel_only in (("grouped", False), ("panel", True))],
    pytest.param("low_noise_fixture", "complete", False,
                 id="lowest_intervals_link_nothing"),
    pytest.param("singletons_fixture", "complete", False,
                 id="singleton_intervals_only"),
])
def test_generate_clusters_matches_jax(request, corpus, linkage,
                                       panel_only):
    dataset = request.getfixturevalue(corpus)
    args = (dataset, linkage, 0.1, 0, 20.0, "ppm", None, 0.05, 2**15)
    labels, medoids = engine.generate_clusters(
        *args, max_peaks=50, device="cpu", panel_only=panel_only)
    ref_labels, ref_medoids = jax_engine.generate_clusters(
        *args, max_peaks=50, backend="xla")
    np.testing.assert_array_equal(labels, ref_labels)
    np.testing.assert_array_equal(medoids, ref_medoids)
    if corpus == "low_noise_fixture":
        # The label offset advanced past the intervals that linked
        # nothing: no spectrum has label 0.
        assert labels.min() > 0
        assert len(np.unique(labels)) < len(labels)
    if corpus == "singletons_fixture":
        assert sorted(labels) == list(range(len(labels)))
        assert sorted(medoids) == list(range(len(labels)))


@pytest.mark.parametrize("panel_only", [False, True],
                         ids=["grouped", "panel"])
def test_generate_clusters_dense_intervals(dense_fixture, panel_only):
    args = (dense_fixture, "complete", 0.2, 0, 20.0, "ppm", 30.0, 0.05,
            2**15)
    labels, medoids = engine.generate_clusters(
        *args, max_peaks=50, device="cpu", panel_only=panel_only)
    ref_labels, ref_medoids = jax_engine.generate_clusters(
        *args, max_peaks=50, backend="xla")
    np.testing.assert_array_equal(labels, ref_labels)
    np.testing.assert_array_equal(medoids, ref_medoids)
    assert len(np.unique(labels)) < len(labels)  # something clustered


def test_routes_split_at_group_max(dense_fixture, monkeypatch):
    # Intervals up to GROUP_MAX go to the grouped scorer, larger ones to
    # the panel scorer.
    calls = {"grouped": 0, "panel": 0}
    grouped, condensed = (pairwise.condensed_distance_groups,
                          pairwise.condensed_distances)

    def count_grouped(*a, **k):
        calls["grouped"] += 1
        return grouped(*a, **k)

    def count_panel(*a, **k):
        calls["panel"] += 1
        return condensed(*a, **k)

    monkeypatch.setattr(pairwise, "condensed_distance_groups",
                        count_grouped)
    monkeypatch.setattr(pairwise, "condensed_distances", count_panel)
    args = (dense_fixture, "complete", 0.2, 0, 20.0, "ppm", None, 0.05,
            2**15)
    monkeypatch.setattr(engine, "GROUP_MAX", 20)
    engine.generate_clusters(*args, device="cpu")
    assert calls == {"grouped": 1, "panel": 1}  # the 50-spectrum interval


def test_multi_device_request(dataset_fixture, caplog):
    args = (dataset_fixture, "complete", 0.1, 0, 20.0, "ppm", None, 0.05,
            2**15)
    # Fewer devices visible than asked for: a warning, then one device.
    with caplog.at_level("WARNING", logger="falcon_tpu"):
        labels, _ = engine.generate_clusters(*args, devices=4, device="cpu")
    assert "only 1 visible" in caplog.text
    ref, _ = engine.generate_clusters(*args, device="cpu")
    np.testing.assert_array_equal(labels, ref)


def test_cuda_device_without_gpu_raises(dataset_fixture, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is visible")
    monkeypatch.delenv("FALCON_TPU_TORCH_DEVICE", raising=False)
    args = (dataset_fixture, "complete", 0.1, 0, 20.0, "ppm", None, 0.05,
            2**15)
    with pytest.raises(RuntimeError, match="FALCON_TPU_TORCH_DEVICE"):
        engine.generate_clusters(*args)
