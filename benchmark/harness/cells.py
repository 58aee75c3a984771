"""What a run is asked to do, found by name: the cell in BENCHMARK.json,
its configuration file, its traffic file (benchmark/traffic/<traffic>.json,
whose `runner` names benchmark/runners/<runner>.py), its limits
(benchmark/limits/<cell>.json) and the per-layer metrics that list it
(benchmark/metrics/<metric>.py).  Adding a cell, a configuration, a
traffic mix or a metric adds files and entries; nothing here changes."""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
from typing import Dict, List


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]
    root: str

    @property
    def bench_dir(self) -> str:
        return os.path.join(self.root, "benchmark")


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(root: str, name: str) -> Cell:
    """The cell `name` of root/BENCHMARK.json; KeyError if it has none."""
    bench = _load(os.path.join(root, "BENCHMARK.json"))
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(work)})")
    w = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _load(os.path.join(root, "benchmark", "traffic", w["traffic"] + ".json"))
    limits_path = os.path.join(root, "benchmark", "limits", name + ".json")
    limits = _load(limits_path) if os.path.exists(limits_path) else {}
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    per_layer = [m for m in bench["per_layer"] if _reports(m, name)]
    return Cell(name, int(w["chips"]), config, traffic, limits, e2e, per_layer, root)


def runner(cell: Cell):
    """The module that runs the cell's traffic: benchmark.runners.<runner>."""
    return importlib.import_module(f"benchmark.runners.{cell.traffic['runner']}")


def metric_reader(cell: Cell, name: str):
    """read(ctx) of benchmark/metrics/<name>.py."""
    path = os.path.join(cell.bench_dir, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def per_layer_values(cell: Cell, ctx: dict) -> Dict[str, dict]:
    """Each per-layer metric of the cell that finds something to read in
    `ctx`, with its unit; a reader that returns None is left out."""
    out = {}
    for m in cell.per_layer:
        value = metric_reader(cell, m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
