"""The benchmark's files, found by name.

``BENCHMARK.json`` at the checkout's root lists the cells and metrics; a
cell's file is ``bench/workloads/<cell>.json``, its configuration's
``bench/configs/<config>.json``, its traffic's
``bench/traffic/<traffic>.json``, its operators' latency table
``bench/latencies/<cell>.json``, its runner ``bench/runners/<runner>.py``
(named by the traffic), its reference ``bench/reference/<family>.py``
(named by the configuration) and each per-layer metric's reader
``bench/metrics/<metric>.py``.  Adding a cell, a configuration or a
metric adds files and entries; it edits none.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import pathlib
from typing import Dict, List, Optional

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    spec: dict                  # this cell's entry of BENCHMARK.json
    cell: dict                  # bench/workloads/<name>.json
    config: dict                # bench/configs/<config>.json
    traffic: dict               # bench/traffic/<traffic>.json
    end_to_end: List[dict]      # the end-to-end metrics this cell reports
    per_layer: List[dict]       # the per-layer metrics this cell reports
    latencies: Optional[Dict[str, float]]  # bench/latencies/<name>.json

    @property
    def reference(self):
        return importlib.import_module(
            f"reference.{self.config['family']}")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: Optional[dict] = None) -> Cell:
    bench = bench if bench is not None else load_json(ROOT /
                                                      "BENCHMARK.json")
    specs = {w["name"]: w for w in bench["workloads"]}
    if name not in specs:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"known: {sorted(specs)}")
    spec = specs[name]
    cell = load_json(BENCH / "workloads" / f"{name}.json")
    table = BENCH / "latencies" / f"{name}.json"
    for key in ("config", "traffic"):
        if cell[key] != spec[key]:
            raise ValueError(f"{name}: {key} {cell[key]!r} in its file, "
                             f"{spec[key]!r} in BENCHMARK.json")
    return Cell(name=name, spec=spec, cell=cell,
                config=load_json(BENCH / "configs" / f"{spec['config']}.json"),
                traffic=load_json(BENCH / "traffic" /
                                  f"{spec['traffic']}.json"),
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name)],
                latencies=(load_json(table)["seconds"] if table.exists()
                           else None))


def reader(metric: str):
    """The module ``bench/metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def runner(cell: Cell):
    """The module ``bench/runners/<runner>.py`` that runs the cell's
    traffic."""
    return importlib.import_module(f"runners.{cell.traffic['runner']}")


def read_per_layer(cell: Cell, readings: Dict) -> Dict[str, dict]:
    """Each per-layer metric of ``cell`` that its reader finds something
    to read for, as ``{"value", "unit"}``."""
    out = {}
    for m in cell.per_layer:
        value = reader(m["name"]).read(readings)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
