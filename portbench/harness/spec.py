"""Cells, configurations, traffic mixes, limits and metric readers, found by
the names ``BENCHMARK.json`` gives them.

- ``portbench/configs/<config>.json``: the configuration as it is run;
- ``portbench/traffic/<traffic>.json``: the mix's parameters; its ``job``
  names the runner ``portbench/jobs/<job>.py``;
- ``portbench/limits/<workload>.json``: the limit of each number the check
  compares in that cell;
- ``portbench/metrics/<metric>.py``: the reader of a per-layer metric (a
  split metric's parts may share one, see ``metric_reader``).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

from portbench.harness.env import ROOT

PB = ROOT / "portbench"


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


class Cell:
    """One workload of BENCHMARK.json with its files."""

    def __init__(self, name: str, bench: dict | None = None):
        bench = benchmark() if bench is None else bench
        by_name = {w["name"]: w for w in bench["workloads"]}
        if name not in by_name:
            raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json ({sorted(by_name)})")
        self.name = name
        self.workload = by_name[name]
        self.chips = int(self.workload["chips"])
        self.config_entry = {c["name"]: c for c in bench["configs"]}[self.workload["config"]]
        self.config = load_json(ROOT / self.config_entry["file"])
        self.traffic = load_json(PB / "traffic" / f"{self.workload['traffic']}.json")
        self.limits = load_json(PB / "limits" / f"{name}.json")
        self.end_to_end = [m for m in bench["end_to_end"] if _applies(m, name)]
        e2e_names = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"] if _applies(m, name) and m["moves"] in e2e_names]
        self.run_seconds = int(bench["run_seconds"])

    def job_module(self):
        return importlib.import_module(f"portbench.jobs.{self.traffic['job']}")


def metric_reader(name: str):
    """The ``read(ctx)`` of ``portbench/metrics/<name>.py``, or, where there
    is none, of the reader its split shares: ``<name without its last
    dotted part>.py``."""
    path = PB / "metrics" / f"{name}.py"
    if not path.exists():
        path = PB / "metrics" / f"{name.rsplit('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
