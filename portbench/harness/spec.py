"""Finding a cell's parts by name.

`BENCHMARK.json` at the root of the checkout is the list of cells: each
workload names its configuration and its traffic mix, and each metric
lists the cells that report it. Every part a cell uses is a file of its
own under `portbench/`, found by its name:

- a configuration: `configs/<config>.json`;
- a traffic mix: `traffic/<traffic>.json`, data only: its request kind,
  its arrivals and their parameters;
- a request kind: `kinds/<kind>.py`;
- a per-layer metric's reader: `metrics/<name>.py`, or, for a metric named
  `<base>.<suffix>`, `metrics/<base>.py`.

A later cell adds files and entries; it edits none that is there.
"""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(*parts: str) -> dict:
    with open(os.path.join(BENCH_DIR, *parts)) as f:
        return json.load(f)


def _module(path: str, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def config(name: str) -> dict:
    return _json("configs", f"{name}.json")


def traffic(name: str) -> dict:
    return _json("traffic", f"{name}.json")


def kind(name: str) -> ModuleType:
    return _module(os.path.join(BENCH_DIR, "kinds", f"{name}.py"),
                   f"portbench_kind_{name}")


def reader(metric: str) -> ModuleType:
    """The reader of a per-layer metric: `metrics/<metric>.py`, else
    `metrics/<base>.py` for `<base>.<suffix>`."""
    for stem in (metric, metric.split(".", 1)[0]):
        path = os.path.join(BENCH_DIR, "metrics", f"{stem}.py")
        if os.path.isfile(path):
            return _module(path, "portbench_metric_"
                           + stem.replace(".", "_").replace("-", "_"))
    raise FileNotFoundError(f"no reader for the metric {metric}")


class Cell:
    """One workload of BENCHMARK.json with everything it names."""

    def __init__(self, name: str, bench: dict):
        work = {w["name"]: w for w in bench["workloads"]}
        if name not in work:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.work = work[name]
        self.config = config(self.work["config"])
        self.traffic = traffic(self.work["traffic"])
        self.kind = kind(self.traffic["kind"])
        self.end_to_end: List[dict] = [
            m for m in bench["end_to_end"]
            if name in m.get("workloads", [name])]
        moves = {m["name"] for m in self.end_to_end}
        self.per_layer: List[dict] = [
            m for m in bench["per_layer"]
            if name in m.get("workloads", [name] if m["moves"] in moves
                             else [])]
        self.readers: Dict[str, ModuleType] = {
            m["name"]: reader(m["name"]) for m in self.per_layer}
