"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration, whose file the
``configs`` entry gives, and a traffic mix, read from
``zsbench/traffic/<traffic>.json``; the mix names its runner, the module
``zsbench/runners/<runner>.py`` that runs the program's entry point. The
limits of the cell's comparison are in ``zsbench/limits/<cell>.json``, and a
per-layer metric's reader is ``zsbench/metrics/<metric>.py``. Adding a
configuration, a mix, a cell or a metric adds files; no file here changes.
"""

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load(root=ROOT):
    path = Path(root) / "BENCHMARK.json"
    if not path.is_file():
        raise SystemExit(f"no BENCHMARK.json at {root}")
    return json.loads(path.read_text())


def cell(bench, name):
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def config(bench, name, root=ROOT):
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((Path(root) / c["file"]).read_text())
    raise SystemExit(f"no config {name!r} in BENCHMARK.json")


def traffic(name, here=HERE):
    return json.loads((Path(here) / "traffic" / f"{name}.json").read_text())


def limits(workload, here=HERE):
    return json.loads((Path(here) / "limits" / f"{workload}.json").read_text())


def runner(name):
    """The module ``runners/<name>.py``, whose ``Runner`` runs a mix's entry point."""
    return importlib.import_module(f"zsbench.runners.{name}")


def reader(metric, here=HERE):
    """The module ``metrics/<metric>.py`` (its ``value(ctx)`` reads the metric or returns None)."""
    path = Path(here) / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"zsbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reports(metric, workload):
    """Whether ``workload`` reports ``metric`` (a metric without ``workloads`` is every cell's)."""
    return "workloads" not in metric or workload in metric["workloads"]


def end_to_end(bench, workload):
    return [m for m in bench["end_to_end"] if reports(m, workload)]


def per_layer(bench, workload):
    """The per-layer metrics ``workload`` reports: those that list it, and
    those without a list whose end-to-end metric it reports."""
    mine = {m["name"] for m in end_to_end(bench, workload)}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in mine)]
