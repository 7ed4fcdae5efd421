"""The cells ``ann-run-50k`` and ``ann-ivf-262k`` end to end on the CPU
(the kernels' plain versions, their tiny mixes), a fault underneath each,
and each cell on the card."""

import json

import pytest

from .conftest import last_json, make_root
from .test_pb_harness import _patch_engines, _run, _singletons

CELL = "ann-run-50k"
IVF_CELL = "ann-ivf-262k"


def _wanted(root, workload, kind, card=False):
    """The metrics of ``kind`` the cell reports; the device's readings
    only on the card."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    return sorted(m["name"] for m in bench[kind]
                  if workload in m.get("workloads", [workload])
                  and (card or m["source"] != "device_trace"))


def _rehearse(root, workload, trace, capsys):
    rc, out = _run(root, workload, trace, capsys)
    assert rc == 0
    result = last_json(out.out)
    assert result["correct"] is True
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert sorted(result["metrics"]) == _wanted(
        root, workload, "per_layer" if trace else "end_to_end")
    for name, metric in result["metrics"].items():
        assert metric["value"] is not None
        assert metric["value"] > 0 or name == "peak_device_gib"


def _fails_alone(root, workload, capsys, monkeypatch):
    _patch_engines(monkeypatch, _singletons)
    rc, out = _run(root, workload, 0, capsys)
    assert rc == 0
    result = last_json(out.out)
    assert result["correct"] is False
    check = result["checks"]["label_disagree"]
    assert check["value"] > check["limit"]


@pytest.mark.parametrize("trace", [0, 1])
def test_new_cell_rehearsal(tiny_root, capsys, trace):
    _rehearse(tiny_root, CELL, trace, capsys)


@pytest.mark.parametrize("trace", [0, 1])
def test_ivf_cell_rehearsal(tiny_root, capsys, trace):
    _rehearse(tiny_root, IVF_CELL, trace, capsys)


def test_every_spectrum_alone_fails_the_new_cell(tiny_root, capsys,
                                                 monkeypatch):
    _fails_alone(tiny_root, CELL, capsys, monkeypatch)


def test_every_spectrum_alone_fails_the_ivf_cell(tiny_root, capsys,
                                                 monkeypatch):
    _fails_alone(tiny_root, IVF_CELL, capsys, monkeypatch)


def _on_the_card(tmp_path, workload, capsys):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    root = make_root(tmp_path)
    rc, out = _run(root, workload, 1, capsys, need_card=True)
    assert rc == 0
    result = last_json(out.out)
    assert result["correct"] is True
    assert sorted(result["metrics"]) == _wanted(root, workload, "per_layer",
                                                card=True)


@pytest.mark.cuda
def test_new_cell_on_the_card(tmp_path, capsys):
    """The new cell at the tiny size on the card, traced: every per-layer
    metric read."""
    _on_the_card(tmp_path, CELL, capsys)


@pytest.mark.cuda
def test_ivf_cell_on_the_card(tmp_path, capsys):
    """The IVF cell at the tiny size on the card, traced: every per-layer
    metric read, the IVF kernels' device time among them."""
    _on_the_card(tmp_path, IVF_CELL, capsys)
