"""Resolve a cell of BENCHMARK.json into what a run needs, by name.

A cell (an entry of `workloads`) names a configuration and a traffic mix.
The configuration is `configs/<config>.json`, the traffic mix
`traffic/<config>.<traffic>.json` (the generator's parameters), and each
per-layer metric a reader `metrics/<metric>.py`. Adding a cell, a
configuration or a metric takes new files and entries only.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import List, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


@dataclass
class Metric:
    name: str
    unit: str
    layer: Optional[str] = None
    moves: Optional[str] = None
    reader: object = None  # the metric's module (per-layer metrics)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    traffic_file: str
    end_to_end: List[Metric] = field(default_factory=list)
    per_layer: List[Metric] = field(default_factory=list)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def config_path(name: str) -> str:
    return os.path.join(BENCH_DIR, "configs", f"{name}.json")


def traffic_path(config: str, traffic: str) -> str:
    return os.path.join(BENCH_DIR, "traffic", f"{config}.{traffic}.json")


def load_metric_reader(name: str):
    """The module metrics/<name>.py (names hold dots, so it is loaded by
    path). It defines LAYER, UNIT and MOVES, and read(ctx) -> a number,
    or None where the run gave it nothing to read."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "polishbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def resolve(cell_name: str, bench: Optional[dict] = None) -> Cell:
    """The cell `cell_name` of BENCHMARK.json with its configuration,
    traffic and metrics loaded. Raises KeyError for an unknown cell."""
    bench = bench if bench is not None else load_benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == cell_name),
                 None)
    if entry is None:
        raise KeyError(f"no workload {cell_name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"]
                     if c["name"] == entry["config"])
    tpath = traffic_path(entry["config"], entry["traffic"])
    cell = Cell(name=cell_name, chips=int(entry["chips"]),
                config=load_json(os.path.join(ROOT, cfg_entry["file"])),
                traffic=load_json(tpath), traffic_file=tpath)
    for m in bench["end_to_end"]:
        if _applies(m, cell_name):
            cell.end_to_end.append(Metric(m["name"], m["unit"]))
    for m in bench["per_layer"]:
        if _applies(m, cell_name):
            cell.per_layer.append(Metric(m["name"], m["unit"], m["layer"],
                                         m["moves"],
                                         load_metric_reader(m["name"])))
    return cell
