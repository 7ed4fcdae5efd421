"""The cell ``ann-dbscan-262k`` (falcon's published DBSCAN on the project
corpus) end to end on the CPU (the kernels' plain versions, its tiny mix),
the fault that leaves every spectrum alone, and the cell on the card."""

import pytest

from .test_pb_new_cells import _fails_alone, _on_the_card, _rehearse

CELL = "ann-dbscan-262k"


@pytest.mark.parametrize("trace", [0, 1])
def test_dbscan_cell_rehearsal(tiny_root, capsys, trace):
    """Every metric BENCHMARK.json lists for the cell is read, each above
    0 (the device's readings only on the card), and the run is correct."""
    _rehearse(tiny_root, CELL, trace, capsys)


def test_every_spectrum_alone_fails_the_dbscan_cell(tiny_root, capsys,
                                                    monkeypatch):
    _fails_alone(tiny_root, CELL, capsys, monkeypatch)


@pytest.mark.cuda
def test_dbscan_cell_on_the_card(tmp_path, capsys):
    """The DBSCAN cell at the tiny size on the card, traced: every
    per-layer metric read."""
    _on_the_card(tmp_path, CELL, capsys)
