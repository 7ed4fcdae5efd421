"""The benchmark's generator against the port's, and its MGF file."""

import numpy as np
import pytest

from falcon_tpu_torch import simulate
from falcon_tpu_torch.ms_io import mgf_io
from portbench import generator


@pytest.mark.parametrize("kwargs", [
    dict(n_clusters=60, cluster_size=7, n_noise=40, precursor_classes=12,
         seed=5),
    dict(n_clusters=30, cluster_size=3, n_noise=20, seed=2**33 + 7),
    dict(n_clusters=25, cluster_size=10, n_noise=15, precursor_classes=4,
         charges=(1, 2, 3, 4), dropout=0.5, seed=0),
])
def test_fixed_sizes_give_the_ports_spectra(kwargs):
    corpus = generator.make_clustered_spectra(**kwargs)
    spectra, labels = simulate.make_clustered_spectra(**kwargs)
    assert len(spectra) == len(corpus)
    np.testing.assert_array_equal(labels, corpus.truth)
    for i, s in enumerate(spectra):
        a, b = corpus.offsets[i], corpus.offsets[i + 1]
        assert s.identifier == corpus.title(i)
        np.testing.assert_array_equal(s.mz, corpus.mz[a:b].astype(np.float32))
        np.testing.assert_array_equal(
            s.intensity, corpus.intensity[a:b].astype(np.float32))
        assert s.precursor_mz == corpus.precursor_mz[i]
        assert s.precursor_charge == corpus.charge[i]
        assert s.retention_time == corpus.rt[i]


def test_power_law_sizes():
    sizes = generator.power_law_sizes(183501, 2.0, 2, 500, 262144)
    assert sizes.sum() == 183501
    assert sizes.min() >= 2 and sizes.max() <= 500
    again = generator.power_law_sizes(183501, 2.0, 2, 500, 262144)
    np.testing.assert_array_equal(sizes, again)
    # The law's mean size on 2..500 is about 8.9; the pairs a clustered
    # spectrum has in its cluster, E[s^2]/E[s], about 85.
    assert 8.0 < sizes.mean() < 10.0
    assert 70 < (sizes ** 2).sum() / sizes.sum() < 100


def test_traffic_keeps_its_shape_across_seeds():
    """Every seed draws the same cluster sizes and, with a structure seed,
    the same precursor classes and charges: only the spectra differ."""
    traffic = {"cluster_sizes": {"law": "power", "exponent": 2.0, "min": 2,
                                 "max": 40, "total": 500, "seed": 3},
               "n_noise": 50, "precursor_classes": 9, "structure_seed": 8}
    a = generator.from_traffic(traffic, 1)
    b = generator.from_traffic(traffic, 2**31 + 5)
    assert len(a) == len(b) == 550
    size_a = np.bincount(a.truth[~a.is_noise])
    size_b = np.bincount(b.truth[~b.is_noise])
    np.testing.assert_array_equal(size_a, size_b)
    by_truth_a, by_truth_b = np.argsort(a.truth), np.argsort(b.truth)
    np.testing.assert_array_equal(a.charge[by_truth_a], b.charge[by_truth_b])
    np.testing.assert_allclose(a.precursor_mz[by_truth_a],
                               b.precursor_mz[by_truth_b], rtol=5e-5)
    assert not np.array_equal(a.precursor_mz, b.precursor_mz)
    assert not np.array_equal(a.mz[:50], b.mz[:50])


def test_mgf_holds_the_quantized_values(tmp_path):
    corpus = generator.quantize(generator.make_clustered_spectra(
        n_clusters=20, cluster_size=4, n_noise=30, precursor_classes=5,
        rt_range=(-50.0, 20.0), seed=11))
    path = tmp_path / "c.mgf"
    size = generator.write_mgf(str(path), corpus)
    assert size == path.stat().st_size
    spectra = list(mgf_io.get_spectra(str(path)))
    assert len(spectra) == len(corpus)
    assert (corpus.rt < 0).any()
    for i, s in enumerate(spectra):
        a, b = corpus.offsets[i], corpus.offsets[i + 1]
        assert s.identifier == corpus.title(i)
        np.testing.assert_array_equal(s.mz, corpus.mz[a:b].astype(np.float32))
        np.testing.assert_array_equal(
            s.intensity, corpus.intensity[a:b].astype(np.float32))
        assert s.precursor_mz == corpus.precursor_mz[i]
        assert s.retention_time == corpus.rt[i]
        assert s.precursor_charge == corpus.charge[i]


def test_fixed_point_digits():
    x = np.array([0.0, 1.5, -2.25, 123.456789, -0.5, 99999.1, 9.9999996])
    rows = generator._fixed_point(x, 3)
    text = [r[r != 0].tobytes().decode() for r in rows]
    assert text == ["0.000", "1.500", "-2.250", "123.457", "-0.500",
                    "99999.100", "10.000"]
