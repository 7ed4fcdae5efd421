"""BENCHMARK.json keeps the shape its readers rely on."""

import json
import re

from .conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    for entry in BENCH["configs"]:
        assert set(entry) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(entry["name"]) and _line(entry["source"])
        assert _line(entry["why"])
        assert (REPO / entry["file"]).is_file()
        assert entry["file"].startswith(BENCH["paths"][0] + "/")
    for cell in BENCH["workloads"]:
        assert set(cell) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
        assert cell["chips"] in (1, 4) and _line(cell["why"])
        traffic = json.loads((REPO / "portbench" / "traffic"
                              / f"{cell['traffic']}.json").read_text())
        assert _line(traffic["source"])
        assert (REPO / "portbench" / "limits"
                / f"{cell['name']}.json").is_file()
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert _line(m["layer"])
        assert (REPO / "portbench" / "metrics" / f"{m['name']}.py").is_file()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")


def test_every_cell_reports_enough():
    for cell in BENCH["workloads"]:
        def has(m):
            return cell["name"] in m.get("workloads", [cell["name"]])
        e2e = {m["name"] for m in BENCH["end_to_end"] if has(m)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(has(m) for m in BENCH["per_layer"])
        # A per-layer metric moves an end-to-end metric of each of its
        # cells, and not the set-up time.
        for m in BENCH["per_layer"]:
            if has(m):
                assert m["moves"] in e2e - {"setup_s"}, (m["name"], cell)
