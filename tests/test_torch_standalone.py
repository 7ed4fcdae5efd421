"""``falcon_tpu_torch`` stands alone: it imports neither JAX nor anything of
the JAX package ``falcon_tpu``, directly or through another module, and
neither does ``chip_smoke.py``.

One check runs the port in a fresh interpreter (every module imported,
then the CPU CLI end to end) and looks at ``sys.modules``; the other reads
every source file's import statements.
"""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

from falcon_tpu_torch.device import DEVICE_ENV
from falcon_tpu_torch.simulate import make_clustered_spectra, write_mgf

REPO = pathlib.Path(__file__).resolve().parents[1]
SOURCES = sorted(
    str(p.relative_to(REPO))
    for p in [REPO / "chip_smoke.py",
              *(REPO / "falcon_tpu_torch").rglob("*.py")])


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "falcon_tpu")


@pytest.mark.parametrize("flags", [[], ["--backend", "ann", "--ann_index",
                                        "exact"], ["--backend", "ann"]],
                         ids=["exact", "ann_exact", "ann"])
def test_port_runs_without_jax_or_the_jax_package(tmp_path, flags):
    spectra, _ = make_clustered_spectra(n_clusters=6, cluster_size=4,
                                        n_noise=8, seed=3)
    mgf = write_mgf(str(tmp_path / "tiny.mgf"), spectra)
    out = str(tmp_path / "out")
    script = (
        "import importlib, pkgutil, sys\n"
        "import falcon_tpu_torch\n"
        "for m in pkgutil.walk_packages(falcon_tpu_torch.__path__,\n"
        "                               'falcon_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "from falcon_tpu_torch import cli\n"
        f"rc = cli.main([{mgf!r}, {out!r}] + {flags!r})\n"
        "assert rc == 0, rc\n"
        "leaked = sorted(m for m in sys.modules\n"
        "                if m.split('.')[0] in ('jax', 'jaxlib', "
        "'falcon_tpu'))\n"
        "print('FORBIDDEN', leaked)\n"
    )
    env = dict(os.environ, **{DEVICE_ENV: "cpu", "PYTHONPATH": str(REPO)})
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          cwd=str(tmp_path), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "FORBIDDEN []" in proc.stdout
    assert os.path.getsize(out + ".csv") > 0


@pytest.mark.parametrize("source", SOURCES)
def test_source_imports_neither_jax_nor_the_jax_package(source):
    tree = ast.parse((REPO / source).read_text(), filename=source)
    imported = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            imported.append(node.module)
    assert [m for m in imported if _forbidden(m)] == []
