"""``BENCHMARK.json`` and the files it names, resolved for one cell."""

from __future__ import annotations

import importlib
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))


def load_benchmark(root: str = ROOT) -> Dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration, its traffic
    mix and the metrics it reports."""

    name: str
    chips: int
    config: Dict
    traffic: Dict
    end_to_end: List[Dict] = field(default_factory=list)
    per_layer: List[Dict] = field(default_factory=list)

    def driver(self):
        """The driver module of the traffic mix's kind."""
        return importlib.import_module(f"{__package__}.drivers.{self.traffic['kind']}")


def metric_family(name: str) -> str:
    """The reader file of a per-layer metric: its name up to the first dot."""
    return name.split(".", 1)[0]


def metric_reader(name: str):
    return importlib.import_module(f"{__package__}.metrics.{metric_family(name)}")


def _load(root: str, folder: str, name: str) -> Dict:
    with open(os.path.join(root, os.path.basename(HERE), folder, f"{name}.json")) as f:
        return json.load(f)


def load_files(config: str, traffic: str, root: str = ROOT):
    """The configuration and traffic mix of these names, from their files
    (for a cell that ``BENCHMARK.json`` does not hold)."""
    return _load(root, "configs", config), _load(root, "traffic", traffic)


def resolve(workload: str, root: str = ROOT, bench: Dict = None) -> Cell:
    """The cell named ``workload``; KeyError when ``BENCHMARK.json`` has none."""
    bench = load_benchmark(root) if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    traffic = _load(root, "traffic", w["traffic"])
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or workload in m["workloads"]]
    reported = {m["name"] for m in e2e}
    per_layer = [
        m for m in bench["per_layer"]
        if workload in m.get("workloads", []) or ("workloads" not in m and m["moves"] in reported)
    ]
    return Cell(workload, int(w["chips"]), config, traffic, e2e, per_layer)
