"""The plain reference: its pieces, its agreement with the program on the
CPU, and its control, which must fail the limit of every cell."""

import json

import numpy as np
import pytest
import torch

from portbench import generator, reference
from portbench.run import load_cell, read_csv_labels

from .conftest import REPO

SETTINGS = reference.exact_settings(json.loads(
    (REPO / "portbench" / "configs" / "exact-default.json").read_text()
)["settings"])


def test_disagreement():
    d = reference.disagreement
    assert d(np.array([0, 0, 1, 1, 2, -1]), np.array([5, 5, 7, 7, 9, -1])) \
        == 0.0
    assert d(np.array([0, 0, 1, 1, 2, -1]), np.array([5, 5, 7, 8, 9, -1])) \
        == 2 / 5
    # A spectrum only one side keeps disagrees, and so does its cluster.
    assert d(np.array([0, 0, 1, 1, 2, -1]), np.array([5, 5, 7, 7, 9, 4])) \
        == 1 / 6
    assert d(np.array([0, 0, 0, 1, -1]), np.array([3, 3, -1, 3, 3])) == 1.0


def test_interval_splits():
    mz = np.array([500.0, 500.001, 500.002, 600.0, 600.0001])
    np.testing.assert_array_equal(
        reference.interval_splits(mz, 20.0, 32768), [0, 3, 5])
    # A block of batch_size or more is cut evenly.
    np.testing.assert_array_equal(
        reference.interval_splits(np.full(7, 500.0), 20.0, 3),
        [0, 3, 5, 7])


def test_greedy_matching():
    # Peak 0 of a is within tolerance of peaks 0 and 1 of b: the larger
    # product takes it, and b's peak 0 then matches nothing.
    mz = torch.tensor([[100.0, 300.0, -1e4], [100.02, 100.04, 300.01]])
    inten = torch.tensor([[0.8, 0.6, 0.0], [0.5, 0.7, 0.51]])
    d = reference.pair_distances(mz, inten, torch.tensor([0]),
                                 torch.tensor([1]), 0.05, 0, torch.float32)
    assert d.item() == pytest.approx(1 - (0.8 * 0.7 + 0.6 * 0.51), abs=1e-6)
    d2 = reference.pair_distances(mz, inten, torch.tensor([0]),
                                  torch.tensor([1]), 0.05, 3, torch.float32)
    assert d2.item() == 1.0


@pytest.mark.parametrize("flags", [[], ["--backend", "ann"]])
@pytest.mark.parametrize("seed", [11, 2**31 + 99])
def test_program_agrees_on_the_cpu(tmp_path, monkeypatch, flags, seed):
    monkeypatch.setenv("FALCON_TPU_TORCH_DEVICE", "cpu")
    from falcon_tpu_torch import cli

    corpus = generator.quantize(generator.make_clustered_spectra(
        n_clusters=120, cluster_size=6, n_noise=200, precursor_classes=25,
        seed=seed))
    mgf, out = str(tmp_path / "in.mgf"), str(tmp_path / "out")
    generator.write_mgf(mgf, corpus)
    assert cli.main([mgf, out, "--work_dir", str(tmp_path / "w"),
                     "--overwrite", *flags]) == 0
    program = read_csv_labels(out + ".csv", len(corpus))[corpus.scan]
    ref = reference.cluster(corpus, SETTINGS, torch.device("cpu"))
    assert (ref >= 0).sum() > 0.9 * len(corpus)
    assert reference.disagreement(program, ref) == 0.0


@pytest.mark.parametrize("workload", ["ann-project-262k", "exact-run-50k"])
def test_control_fails_the_limit(workload):
    """The bfloat16 reference against the float32 one, at a size a test
    holds (a few thousand spectra, the cell's traffic shape)."""
    from portbench.control import control_reading

    cell, config, traffic, limits, _, _ = load_cell(REPO, workload)
    small = dict(traffic)
    if "cluster_sizes" in small:
        small["cluster_sizes"] = dict(small["cluster_sizes"], total=2400)
        small["n_noise"], small["precursor_classes"] = 1000, 40
    else:
        small.update(n_clusters=240, n_noise=1000, precursor_classes=40)
    readings = [control_reading(config, small, seed, torch.device("cpu"))
                ["label_disagree"] for seed in (1, 2, 3)]
    assert min(readings) > limits["label_disagree"]
