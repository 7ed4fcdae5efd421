"""The harness end to end on the CPU (the kernels' plain versions), with
the timed path broken underneath it, and on the card."""

import json

import numpy as np
import pytest

from portbench import run

from .conftest import last_json, make_root

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def _run(root, workload, trace, capsys, seed=2**32 + 17, need_card=False):
    rc = run.main(["--workload", workload, "--seed", str(seed),
                   "--seconds", "0.5", "--trace", str(trace)],
                  root=root, need_card=need_card)
    out = capsys.readouterr()
    return rc, out


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", ["ann-project-262k", "exact-run-50k"])
def test_rehearsal(tiny_root, capsys, workload, trace):
    rc, out = _run(tiny_root, workload, trace, capsys)
    assert rc == 0
    result = last_json(out.out)
    assert set(result) <= KEYS | {"breakdown"}
    assert KEYS <= set(result)
    assert list(result)[-1] == "checks"
    assert result["correct"] is True
    assert result["failed"] == 0 and result["attempted"] >= 1
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    kind = "per_layer" if trace else "end_to_end"
    wanted = [m["name"] for m in bench[kind]
              if workload in m.get("workloads", [workload])]
    if trace:
        # The device's readings need a card; the rest is read here.
        wanted = [m for m in wanted
                  if m not in ("kernels.match_roofline",
                               "device.idle_share")]
    assert sorted(result["metrics"]) == sorted(wanted)
    for name, metric in result["metrics"].items():
        assert set(metric) == {"value", "unit"}
        assert metric["value"] > 0 or name == "peak_device_gib"
    # The numbers compared are the last lines of standard error.
    tail = out.err.strip().splitlines()[-len(result["checks"]):]
    assert [line.split(":")[0] for line in tail] == [
        f"check {k}" for k in result["checks"]]


def _singletons(real):
    def generate(*args, **kwargs):
        labels, medoids = real(*args, **kwargs)
        return np.arange(len(labels), dtype=labels.dtype), medoids
    return generate


def _half_left_out(real):
    def generate(*args, **kwargs):
        labels, medoids = real(*args, **kwargs)
        labels = labels.copy()
        half = len(labels) // 2
        labels[half:] = labels.max() + 1 + np.arange(len(labels) - half)
        return labels, medoids
    return generate


def _patch_engines(monkeypatch, wrap):
    from falcon_tpu_torch.cluster import ann_engine, engine

    for module in (engine, ann_engine):
        monkeypatch.setattr(module, "generate_clusters",
                            wrap(module.generate_clusters))


def _alter_scores(monkeypatch):
    from falcon_tpu_torch.ops import pairwise

    real = pairwise.batched_block_scores

    def scores(*args, **kwargs):
        s, m = real(*args, **kwargs)
        return s * 0.97, m
    scores.launches = 0
    monkeypatch.setattr(pairwise, "batched_block_scores", scores)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out",
                                   "answer_altered"])
@pytest.mark.parametrize("workload", ["ann-project-262k", "exact-run-50k"])
def test_faults_fail(tiny_root, capsys, monkeypatch, workload, fault):
    """Each fault a cell can have turns ``correct`` false: clustering that
    leaves every spectrum alone, half of each charge left out of the
    clustering, scores altered where the kernel produces them.  (One card
    a cell: there is no exchange between chips to leave out.)"""
    if fault == "state_unchanged":
        _patch_engines(monkeypatch, _singletons)
    elif fault == "half_left_out":
        _patch_engines(monkeypatch, _half_left_out)
    else:
        _alter_scores(monkeypatch)
    rc, out = _run(tiny_root, workload, 0, capsys)
    assert rc == 0
    result = last_json(out.out)
    assert result["correct"] is False
    assert result["checks"]["label_disagree"]["value"] > \
        result["checks"]["label_disagree"]["limit"]


def test_a_pass_that_differs_fails(tiny_root, capsys, monkeypatch):
    """A pass whose CSV is not the warm pass's counts as failed."""
    from falcon_tpu_torch.cluster import engine

    real = engine.generate_clusters
    calls = []

    def generate(*args, **kwargs):
        calls.append(1)
        labels, medoids = real(*args, **kwargs)
        if len(calls) > 2:  # the window's passes, after the warm one
            labels = labels.copy()
            labels[:2] = labels[::-1][:2]
        return labels, medoids
    monkeypatch.setattr(engine, "generate_clusters", generate)
    rc, out = _run(tiny_root, "exact-run-50k", 0, capsys)
    result = last_json(out.out)
    assert result["correct"] is False
    assert result["checks"]["differing_csvs"]["value"] >= 1


@pytest.mark.cuda
def test_on_the_card(tmp_path, capsys):
    """Both cells at the tiny size on the card, kernels and all."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    root = make_root(tmp_path)
    for workload in ("ann-project-262k", "exact-run-50k"):
        for trace in (0, 1):
            rc, out = _run(root, workload, trace, capsys, need_card=True)
            assert rc == 0
            result = last_json(out.out)
            assert result["correct"] is True
            assert result["device"]["platform"] == "gpu"
            if trace:
                assert result["device"]["busy_s"] > 0
                assert 0 < result["metrics"]["kernels.match_roofline"][
                    "value"] <= 100


def test_needs_a_card(tmp_path, capsys):
    """Without a card the harness prints no result and fails."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    root = make_root(tmp_path)
    rc = run.main(["--workload", "exact-run-50k", "--seed", "1",
                   "--seconds", "1", "--trace", "0"], root=root)
    assert rc != 0
    assert capsys.readouterr().out == ""
