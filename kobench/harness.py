"""Finds a cell's pieces by name and turns a driver's outcome into the
result line.

A cell is an entry of `BENCHMARK.json`'s ``workloads``. Its configuration
is the file its ``configs`` entry names; its traffic mix is
``kobench/traffic/<traffic>.json``, which names the driver
(``kobench/drivers/<driver>.py``) and holds the limits of the numbers that
decide `correct`; each per-layer metric is read by
``kobench/metrics/<metric>.py``. Adding a cell, a mix or a metric adds
files and entries and edits none.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
from dataclasses import dataclass, field
from pathlib import Path

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "kubeoperator_tpu")


@dataclass
class Cell:
    name: str
    root: Path
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])


def _applies(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(root: Path, name: str) -> Cell:
    """The cell `name` of `root`/BENCHMARK.json with its files read."""
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"kobench: no workload {name!r} in BENCHMARK.json "
                         f"(have {', '.join(sorted(work))})")
    entry = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[entry["config"]]["file"]).read_text())
    traffic = json.loads(
        (root / "kobench" / "traffic" / f"{entry['traffic']}.json").read_text())
    return Cell(name=name, root=root, workload=entry, config=config,
                traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def metric_reader(root: Path, name: str):
    """`read(layer) -> float | None` of ``kobench/metrics/<name>.py``."""
    path = Path(root) / "kobench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "kobench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def driver(cell: Cell):
    return importlib.import_module(f"kobench.drivers.{cell.traffic['driver']}")


def checks(readings: dict, limits: dict) -> dict:
    """{name: [value, limit]} for every reading the traffic mix limits; a
    limited number the run did not give reads as infinite."""
    return {name: [readings.get(name, math.inf), limit]
            for name, limit in limits.items()}


def passed(compared: dict) -> bool:
    return all(math.isfinite(v) and v <= lim for v, lim in compared.values())


def forbidden_loaded() -> list[str]:
    """Modules of JAX or the JAX package in this process, compared by whole
    top-level name."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


def result(cell: Cell, outcome: dict, trace: bool, setup_s: float) -> dict:
    """The result line of one run from the driver's outcome."""
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = metric_reader(cell.root, m["name"])(outcome["layer"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            value = setup_s if m["name"] == "setup_s" else outcome["e2e"][m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    compared = checks(outcome["readings"], cell.traffic["limits"])
    device = {"platform": "gpu", "kind": outcome["kind"],
              "count": cell.chips,
              "memory_peak_bytes": int(outcome["memory_peak_bytes"])}
    line = {"correct": passed(compared),
            "attempted": outcome["attempted"], "failed": outcome["failed"],
            "metrics": metrics, "device": device}
    summary = outcome["layer"].get("trace")
    if trace and summary:
        device["busy_s"] = summary["busy_s"] / summary["ranks"]
        device["window_s"] = outcome["layer"]["window_s"]
        line["breakdown"] = {"device_ops": summary["device_ops"],
                             "idle_gaps": summary["idle_gaps"]}
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in compared.items()}
    return line
