"""Everything a run reads by name: the cell from ``BENCHMARK.json``, its
configuration file and frozen data, its traffic file and the readers of
its metrics.

A configuration, a traffic mix or a metric is added by adding its file
and its entry in ``BENCHMARK.json``; nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List

ROOT = Path(__file__).resolve().parents[2]
TRAFFIC_DIR = Path("portbench") / "traffic"
METRICS_DIR = Path("portbench") / "metrics"


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict            # the configuration file
    traffic: Dict           # the traffic file
    docs: List[Dict]        # frozen artifacts, in the configuration's order
    end_to_end: List[Dict]  # BENCHMARK.json entries this cell reports
    per_layer: List[Dict]
    root: Path


def _reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; BENCHMARK.json has "
                       f"{sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    data = root / config["data"]
    return Cell(
        name=name, chips=int(cell["chips"]), config=config,
        traffic=json.loads((root / TRAFFIC_DIR / f"{cell['traffic']}.json")
                           .read_text()),
        docs=[json.loads((data / f"{k}.json").read_text())
              for k in config["kernels"]],
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
        root=root)


def reader(root: Path, metric: str) -> Callable:
    """``read(window)`` of ``portbench/metrics/<metric>.py``."""
    path = root / METRICS_DIR / f"{metric}.py"
    module_name = "portbench_metric_" + "".join(
        ch if ch.isalnum() else "_" for ch in metric)
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
