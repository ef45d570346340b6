"""Finding a cell's pieces by name: `BENCHMARK.json` names the cell, its
configuration and traffic; the configuration's file is the one it lists,
the traffic mix is `traffic/<name>.json`, its driver
`drivers/<driver>.py`, and each metric's reader `metrics/<name>.py` (or
the file of the name before its first dot, `reader`). A
later cell, configuration, traffic mix or metric is a new file and a new
entry; no file here changes for it.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent


def load(checkout: Path = CHECKOUT) -> dict:
    """The parsed `BENCHMARK.json` of a checkout."""
    return json.loads((Path(checkout) / "BENCHMARK.json").read_text())


def _named(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json names no {what} {name!r}")


def cell(bench: dict, name: str) -> dict:
    return _named(bench["workloads"], name, "workload")


def config(bench: dict, name: str, checkout: Path = CHECKOUT) -> dict:
    """A configuration's file, as run."""
    entry = _named(bench["configs"], name, "configuration")
    return json.loads((Path(checkout) / entry["file"]).read_text())


def traffic(name: str, root: Path = HERE) -> dict:
    return json.loads((Path(root) / "traffic" / f"{name}.json").read_text())


def driver(name: str):
    """The driver module of an entry point: `drivers/<name>.py`."""
    return importlib.import_module(f"cardbench.drivers.{name}")


def reader(metric: str, root: Path = HERE):
    """A metric's reader: `read(record)` of `metrics/<name>.py`, or, for
    a name with a dot (`render_fps.cuts`) that has no file of its own, of
    `metrics/<name up to the first dot>.py`, which reads the same quantity
    in every cell. It returns a number, or None when the record holds
    nothing it reads."""
    metrics = Path(root) / "metrics"
    path = metrics / f"{metric}.py"
    if not path.is_file():
        path = metrics / f"{metric.split('.')[0]}.py"
    if not path.is_file():
        raise FileNotFoundError(metrics / f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "cardbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics a run of `workload` reports: its end-to-end metrics
    with `trace` off, its per-layer metrics with it on. A metric with a
    `workloads` list is reported in those cells; a per-layer metric
    without one wherever the metric it moves is; an end-to-end metric
    without one everywhere."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in names)]
