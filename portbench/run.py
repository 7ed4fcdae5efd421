"""The benchmark of falcon_tpu_torch: peak files to CSV on one card.

Run from the root of a checkout, on a machine with an NVIDIA GPU::

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

A workload of ``BENCHMARK.json`` names a configuration (the CLI flags and
the settings they stand for, ``portbench/configs/<name>.json``) and a
traffic mix (the generator's parameters, ``portbench/traffic/<name>.json``).
The run draws the corpus from ``--seed``, writes it as one MGF file under
``$TMPDIR``, runs one untimed pass, then runs passes of
``falcon_tpu_torch.cli.main`` (the function ``python -m falcon_tpu_torch``
runs: MGF to CSV, in a fresh work directory) back to back until ``--seconds``
have passed; the pass running at the deadline finishes and counts.

Every pass must write the warm pass's CSV bytes, and the last pass's labels
must agree with the plain reference (``reference.py``), run once the window
has closed, within the limit of ``portbench/limits/<workload>.json``.  The
last line of standard output is one JSON object; with ``--trace 0`` its
metrics are the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics, each read by ``portbench/metrics/<name>.py`` from the phases, the
matching launches and a ``torch.profiler`` trace of the card
(``.portbench/traces/``).
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import hashlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import generator, quality, reference, tracing  # noqa: E402

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "falcon_tpu")


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _applies(metric, workload):
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(root: Path, workload: str):
    """(cell, configuration, traffic, limits, end-to-end metrics,
    per-layer metrics) of ``workload``, all found by name."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"portbench: no workload {workload!r} in "
                         f"BENCHMARK.json")
    cell = cells[workload]
    files = {c["name"]: c["file"] for c in bench["configs"]}
    config = json.loads((root / files[cell["config"]]).read_text())
    traffic = json.loads(
        (root / "portbench" / "traffic" / f"{cell['traffic']}.json")
        .read_text())
    limits = json.loads(
        (root / "portbench" / "limits" / f"{workload}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload)]
    per_layer = [m for m in bench["per_layer"] if _applies(m, workload)]
    return cell, config, traffic, limits, e2e, per_layer


def load_reader(root: Path, name: str):
    """``read(run)`` of ``portbench/metrics/<name>.py``."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_csv_labels(path: str, n: int):
    """Cluster label of each generated spectrum (by its scan number, the
    position in generation order) in a CSV the CLI wrote; -1 where the CSV
    has no row."""
    import numpy as np

    labels = np.full(n, -1, np.int64)
    with open(path) as f:
        lines = [line for line in f if not line.startswith("#")]
    header = lines[0].rstrip("\n").split(",")
    sid, col = header.index("spectrum_id"), header.index("cluster")
    scans, clusters = [], []
    for line in lines[1:]:
        parts = line.rstrip("\n").split(",")
        scans.append(int(parts[sid].rsplit("_scan", 1)[1]))
        clusters.append(int(parts[col]))
    labels[np.asarray(scans, np.int64)] = clusters
    return labels


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "power limit unknown"


def io_written():
    """(bytes written to storage, bytes passed to write calls) by this
    process so far (``/proc/self/io``)."""
    try:
        fields = dict(line.split(": ") for line in
                      Path("/proc/self/io").read_text().splitlines())
        return int(fields["write_bytes"]), int(fields["wchar"])
    except (OSError, KeyError, ValueError):
        return -1, -1


def _digest(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 22), b""):
            h.update(block)
    return h.hexdigest()


def _say(*parts):
    print("portbench:", *parts, flush=True)


def main(argv=None, root: Path = ROOT, need_card: bool = True) -> int:
    args = parse_args(argv)
    cell, config, traffic, limits, e2e, per_layer = load_cell(
        root, args.workload)

    import torch

    if need_card:
        if not torch.cuda.is_available():
            print("portbench: no CUDA device is visible", file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell["chips"]:
            print(f"portbench: {args.workload} needs {cell['chips']} cards, "
                  f"{torch.cuda.device_count()} visible", file=sys.stderr)
            return 2
    on_card = torch.device("cuda") if need_card else torch.device("cpu")

    from falcon_tpu_torch import cli
    from falcon_tpu_torch.ops import pairwise
    from falcon_tpu_torch.utils.profiling import profiler

    settings = reference.exact_settings(config["settings"])
    scratch = tempfile.mkdtemp(prefix="portbench-")
    phases = tracing.PhaseLog(profiler)
    launches = tracing.LaunchBytes(pairwise) if args.trace else None
    try:
        corpus = generator.quantize(generator.from_traffic(traffic,
                                                           args.seed))
        mgf = os.path.join(scratch, "corpus.mgf")
        mgf_bytes = generator.write_mgf(mgf, corpus)
        work = os.path.join(scratch, "work")
        out = os.path.join(scratch, "out")
        csv_path = out + ".csv"
        cli_args = [mgf, out, "--work_dir", work, "--overwrite",
                    *config["flags"]]

        def clean():
            shutil.rmtree(work, ignore_errors=True)
            for p in (csv_path, out + ".mgf"):
                if os.path.exists(p):
                    os.remove(p)

        def one_pass():
            rc = cli.main(list(cli_args))
            digest = _digest(csv_path) if os.path.exists(csv_path) else None
            return rc, digest

        phases.install()
        rc0, digest0 = one_pass()
        if rc0 != 0 or digest0 is None:
            print(f"portbench: the warm pass failed (exit {rc0})",
                  file=sys.stderr)
            return 1
        clean()
        if need_card:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - START

        phases.spans.clear()
        prof = marker_ns = None
        if need_card:
            torch.cuda.reset_peak_memory_stats()
        if args.trace:
            launches.install()
            if need_card:
                prof = torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA])
                prof.__enter__()
                torch.cuda.synchronize()
                marker_ns = time.time_ns()
                torch.cuda._sleep(1000)
                torch.cuda.synchronize()
        pass_s, failed, differing, bad = [], 0, 0, 0
        w0_ns = time.time_ns()
        t0 = time.perf_counter()
        deadline = t0 + args.seconds
        while True:
            phases.pass_index = len(pass_s)
            p0 = time.perf_counter()
            rc, digest = one_pass()
            now = time.perf_counter()
            pass_s.append(now - p0)
            failed += rc != 0
            differing += digest != digest0
            bad += rc != 0 or digest != digest0
            if now >= deadline:
                break
            clean()
        elapsed = time.perf_counter() - t0
        w1_ns = time.time_ns()
        if need_card:
            torch.cuda.synchronize()
        passes = len(pass_s)
        device_trace = None
        if prof is not None:
            prof.__exit__(None, None, None)
            traces = root / ".portbench" / "traces"
            traces.mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(
                traces / f"{args.workload}-seed{args.seed}.json.gz"))
            device_trace = tracing.DeviceTrace.from_profiler(
                prof, marker_ns, (w0_ns, w1_ns))
            del prof
        phases.uninstall()
        if launches is not None:
            launches.uninstall()
        peak_bytes = (int(torch.cuda.max_memory_allocated())
                      if need_card else 0)

        n = len(corpus)
        labels_by_scan = (read_csv_labels(csv_path, n)
                          if os.path.exists(csv_path) else None)
        clean()
        gc.collect()
        if need_card:
            torch.cuda.empty_cache()

        import numpy as np

        if labels_by_scan is None:
            program = np.full(n, -1, np.int64)
        else:
            program = labels_by_scan[corpus.scan]
        r0 = time.perf_counter()
        ref = reference.cluster(corpus, settings, on_card)
        disagree = reference.disagreement(program, ref)
        ref_s = time.perf_counter() - r0
        kept = program >= 0
        completeness = quality.cluster_completeness(program[kept],
                                                    corpus.truth[kept])
        purity = quality.cluster_purity(program[kept], corpus.truth[kept])

        checks = {
            "label_disagree": (disagree, limits["label_disagree"]),
            "failed_passes": (failed, 0),
            "differing_csvs": (differing, 0),
        }
        correct = all(v <= lim for v, lim in checks.values())

        values = {
            "spectra_per_s": n * passes / elapsed,
            "completeness": completeness,
            "purity": purity,
            "peak_device_gib": peak_bytes / 2**30,
            "setup_s": setup_s,
        }
        device = {"platform": "gpu" if need_card else "cpu",
                  "kind": (torch.cuda.get_device_name(0) if need_card
                           else "cpu"),
                  "count": cell["chips"],
                  "memory_peak_bytes": peak_bytes}
        result_breakdown = None
        if args.trace:
            run = tracing.TracedRun(
                passes=passes, spans=list(phases.spans),
                device=device_trace, match_bytes=launches.total(),
                match_launches=launches.count, spectra=n * passes,
                window_s=elapsed)
            metrics = {}
            for m in per_layer:
                value = load_reader(root, m["name"])(run)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            if device_trace is not None:
                device["busy_s"] = device_trace.busy_s
                device["window_s"] = device_trace.window_s
                result_breakdown = {
                    "device_ops": device_trace.top_ops(),
                    "idle_gaps": device_trace.idle_by_phase(run.spans)}
        else:
            metrics = {m["name"]: {"value": values[m["name"]],
                                   "unit": m["unit"]} for m in e2e}

        written, wchar = io_written()
        if need_card:
            _say(f"card: {torch.cuda.get_device_name(0)}; {card_line()}")
        _say(f"workload {args.workload} seed {args.seed}: {n} spectra, "
             f"MGF {mgf_bytes} bytes; passes {passes} in {elapsed:.6f} s "
             f"(each {', '.join(f'{s:.4f}' for s in pass_s)}); "
             f"spectra/s {values['spectra_per_s']:.4f}; "
             f"setup {setup_s:.4f} s")
        _say(f"completeness {completeness:.6f}, purity {purity:.6f}, "
             f"peak device {peak_bytes} bytes; bytes written {written} "
             f"(write calls {wchar}); reference {ref_s:.4f} s")

        loaded = sorted({m.split(".")[0] for m in sys.modules}
                        & set(FORBIDDEN_MODULES))
        if loaded:
            print(f"portbench: the process holds {', '.join(loaded)}",
                  file=sys.stderr)
            return 3

        result = {"correct": bool(correct), "attempted": passes,
                  "failed": bad, "metrics": metrics,
                  "device": device}
        if result_breakdown is not None:
            result["breakdown"] = result_breakdown
        result["checks"] = {k: {"value": v, "limit": lim}
                            for k, (v, lim) in checks.items()}
        for k, (v, lim) in checks.items():
            print(f"check {k}: {v} (limit {lim})", file=sys.stderr)
        sys.stderr.flush()
        print(json.dumps(result), flush=True)
        return 0
    finally:
        phases.uninstall()
        if launches is not None:
            launches.uninstall()
        shutil.rmtree(scratch, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
