"""The IVF index's switches and the JAX package's retrieval-route switches
on the port's CLI, against the JAX package's, on the CPU (the second half of
``tests/test_torch_switches.py``, apart so that each file stays short).

``FALCON_TPU_IVF_COARSE=plain`` and ``FALCON_TPU_IVF_RANK=cos`` change the
lists, so the port reads them: both CLIs write the same bytes under each
one, on one device and at ``--devices 2``.  The certified approximate
retrieval, the retrieval pass cap, the column chunks, the dispatch cap, the
exact index's row blocks and the IVF index's ``approx_max_k`` only pick a
TPU route: a spy on the JAX package shows that each value below takes its
other route, and the JAX package's bytes with it equal the port's default
bytes, so the port does not read them.
"""

import pytest

from falcon_tpu import cli as jax_cli
from falcon_tpu.cluster import ann_engine as jax_ann
from falcon_tpu.ops import exact_knn as jax_exact_knn
from falcon_tpu.ops import ivf as jax_ivf
from falcon_tpu.ops import knn as jax_knn
from falcon_tpu.simulate import make_clustered_spectra, write_mgf
from falcon_tpu_torch import cli
from falcon_tpu_torch.device import DEVICE_ENV
from test_torch_cli import mgf_inputs  # noqa: F401
from test_torch_switches import (ANN, DBSCAN, DENSE, IVF, OFF, PORTED, _run,
                                 check_ported_switch, dense_inputs)  # noqa: F401


@pytest.mark.parametrize("case", sorted(c for c in PORTED
                                        if c.startswith("ivf")))
def test_ported_switch_identical_to_jax(case, request, monkeypatch, caplog):
    check_ported_switch(case, request, monkeypatch, caplog)


def _spy(monkeypatch, module, name, seen):
    original = getattr(module, name)

    def spy(*args, **kw):
        seen.append((args, kw))
        return original(*args, **kw)

    monkeypatch.setattr(module, name, spy)


@pytest.fixture()
def wide_inputs(tmp_path, monkeypatch):
    # 1,200 charge-2 spectra: more than one 1,024-row block of the scan.
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    spectra, _ = make_clustered_spectra(
        n_clusters=100, cluster_size=8, n_noise=400, seed=17, charges=(2,))
    return tmp_path, [write_mgf(str(tmp_path / "wide.mgf"), spectra)]


# id: (environment, corpus, flags, JAX function spied on, check of its
# calls that the switch took its other route).
def _certified_off(calls):
    return calls and all(kw.get("certified_thr") is None
                         and kw.get("exact_topk") for _, kw in calls)


NOT_READ = {
    "knn_certified_0": (
        {"FALCON_TPU_KNN_CERTIFIED": "0"}, "mgf", ANN,
        (jax_ann, "knn_banded"), _certified_off),
    "knn_certified_0_dense": (
        {"FALCON_TPU_KNN_CERTIFIED": "0"}, "dense", DBSCAN + DENSE,
        (jax_ann, "knn_banded"), _certified_off),
    "widen_pass_cap_4": (
        {"FALCON_TPU_WIDEN_PASS_CAP": "4"}, "dense",
        ANN + DENSE + ["--n_neighbors_ann", "4", "--n_neighbors", "4"],
        (jax_ann, "knn_banded"),
        lambda calls: any(kw.get("resume_boundary") is not None
                          for _, kw in calls)),
    "knn_col_chunk_128": (
        {"FALCON_TPU_KNN_COL_CHUNK": "128"}, "dense", ANN + DENSE,
        (jax_knn, "_merge_topk"), bool),
    "knn_col_chunk_128_rerank_off": (
        {"FALCON_TPU_KNN_COL_CHUNK": "128"}, "dense", ANN + DENSE + OFF,
        (jax_knn, "_merge_topk"), bool),
    "knn_dispatch_pflops_1e-9": (
        {"FALCON_TPU_KNN_DISPATCH_PFLOPS": "1e-9"}, "wide", ANN,
        (jax_knn, "_banded_topk"),
        lambda calls: any(kw.get("row_offset", 0) > 0 for _, kw in calls)),
    "exact_block_rows_64": (
        {"FALCON_TPU_EXACT_BLOCK_ROWS": "64"}, "dense",
        ANN + DENSE + ["--ann_index", "exact"],
        (jax_exact_knn, "_banded_panel_xla"),
        lambda calls: len(calls) > 2
        and all(args[0].shape[0] == 64 for args, _ in calls)),
    "exact_col_chunk_128": (
        {"FALCON_TPU_EXACT_COL_CHUNK": "128"}, "dense",
        ANN + DENSE + ["--ann_index", "exact"],
        (jax_knn, "_merge_topk"), bool),
    "ivf_exact_topk_0": (
        {"FALCON_TPU_IVF_EXACT_TOPK": "0"}, "mgf", IVF,
        (jax_ivf, "_chunk_scan"),
        lambda calls: calls and all(args[-1] is False for args, _ in calls)),
    "ivf_exact_topk_0_dense": (
        {"FALCON_TPU_IVF_EXACT_TOPK": "0"}, "dense", IVF + DENSE,
        (jax_ivf, "_chunk_scan"),
        lambda calls: calls and all(args[-1] is False for args, _ in calls)),
    "ivf_exact_topk_0_rerank_off": (
        {"FALCON_TPU_IVF_EXACT_TOPK": "0"}, "mgf", IVF + OFF,
        (jax_ivf, "_chunk_scan"),
        lambda calls: calls and all(args[-1] is False for args, _ in calls)),
}


@pytest.mark.parametrize("case", sorted(NOT_READ))
def test_unread_switch_changes_no_byte(case, request, monkeypatch):
    env, corpus, flags, (module, name), took_route = NOT_READ[case]
    tmp_path, files = request.getfixturevalue(
        {"mgf": "mgf_inputs", "dense": "dense_inputs",
         "wide": "wide_inputs"}[corpus])
    got = _run(cli, files, tmp_path / "torch" / "out", flags)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    calls = []
    _spy(monkeypatch, module, name, calls)
    want = _run(jax_cli, files, tmp_path / "jax" / "out", flags)
    assert took_route(calls), case
    assert got[0] == want[0]
    assert got[1] == want[1]
