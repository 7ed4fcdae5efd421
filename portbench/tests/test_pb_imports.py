"""What the harness imports, and that cells, mixes and metrics are found
by name from new files alone."""

import json
import os
import subprocess
import sys
import textwrap

from .conftest import REPO, last_json, make_root

FORBIDDEN = {"jax", "jaxlib", "flax", "falcon_tpu"}


def _python(code, cwd, env=None):
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=cwd, capture_output=True, text=True,
                          env={**os.environ, **(env or {})}, timeout=600)


def test_a_run_loads_no_jax(tmp_path):
    """A whole harness run in a process of its own holds none of the JAX
    modules, compared by whole top-level names (``falcon_tpu_torch`` is
    not ``falcon_tpu``)."""
    root = make_root(tmp_path)
    proc = _python(f"""
        import sys
        sys.path.insert(0, {str(REPO)!r})
        from pathlib import Path
        from portbench import run
        rc = run.main(["--workload", "ann-project-262k", "--seed", "3",
                       "--seconds", "0.3", "--trace", "1"],
                      root=Path({str(root)!r}), need_card=False)
        print(sorted({{m.split(".")[0] for m in sys.modules}}))
    """, REPO, {"FALCON_TPU_TORCH_DEVICE": "cpu", "TMPDIR": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = set(eval(proc.stdout.strip().splitlines()[-1]))
    assert "falcon_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    proc = _python(f"""
        import sys
        sys.path.insert(0, {str(REPO)!r})
        from portbench import generator, peaks, quality, reference
        print(sorted({{m.split(".")[0] for m in sys.modules}}))
    """, REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = set(eval(proc.stdout.strip().splitlines()[-1]))
    assert not loaded & (FORBIDDEN | {"falcon_tpu_torch"})


def test_new_files_are_found_by_name(tmp_path, capsys, monkeypatch):
    """A throwaway configuration, traffic mix, limit and metric reader,
    added as new files and entries, run without editing an existing
    file."""
    import tempfile

    from portbench import run

    monkeypatch.setenv("FALCON_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    root = make_root(tmp_path)
    pb = root / "portbench"
    config = json.loads((pb / "configs" / "exact-default.json").read_text())
    config["flags"] = ["--linkage", "complete"]
    (pb / "configs" / "throwaway.json").write_text(json.dumps(config))
    (pb / "traffic" / "throwaway-mix.json").write_text(json.dumps(
        {"n_clusters": 10, "cluster_size": 4, "n_noise": 10}))
    (pb / "limits" / "throwaway-cell.json").write_text(
        json.dumps({"label_disagree": 0.0}))
    (pb / "metrics" / "throwaway.passes.py").write_text(
        "def read(run):\n    return float(run.passes)\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "throwaway",
                             "source": "https://example.org",
                             "file": "portbench/configs/throwaway.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "throwaway-cell",
                               "config": "throwaway",
                               "traffic": "throwaway-mix", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "throwaway.passes", "unit": "passes",
                               "better": "higher", "source": "program_span",
                               "layer": "driver", "moves": "spectra_per_s",
                               "workloads": ["throwaway-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    rc = run.main(["--workload", "throwaway-cell", "--seed", "4",
                   "--seconds", "0.3", "--trace", "1"], root=root,
                  need_card=False)
    assert rc == 0
    result = last_json(capsys.readouterr().out)
    assert result["correct"] is True
    assert result["metrics"]["throwaway.passes"]["value"] >= 1
