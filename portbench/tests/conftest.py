"""Shared set-up of the benchmark's CPU tests: a root holding a copy of
the benchmark's data files and BENCHMARK.json with tiny traffic mixes, so
the harness runs each cell in seconds on the kernels' plain versions."""

import json
import shutil
import tempfile
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]

TINY = {
    "run-50k": {"n_clusters": 40, "cluster_size": 6, "n_noise": 60,
                "precursor_classes": 10},
    "project-262k": {"cluster_sizes": {"law": "power", "exponent": 2.0,
                                       "min": 2, "max": 30, "total": 300,
                                       "seed": 5},
                     "n_noise": 100, "precursor_classes": 12,
                     "n_peaks": [64, 128], "structure_seed": 7},
}


def make_root(tmp: Path) -> Path:
    """A checkout-shaped directory: BENCHMARK.json whose cells use
    ``tiny-<traffic>`` mixes, and the benchmark's data files."""
    root = tmp / "root"
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for cell in bench["workloads"]:
        tiny = f"tiny-{cell['traffic']}"
        (root / "portbench" / "traffic" / f"{tiny}.json").write_text(
            json.dumps(TINY[cell["traffic"]]))
        cell["traffic"] = tiny
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture
def tiny_root(tmp_path, monkeypatch):
    monkeypatch.setenv("FALCON_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return make_root(tmp_path)


def last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])
