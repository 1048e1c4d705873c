"""The benchmark's data, found by name.

``BENCHMARK.json`` at the root of the checkout names the cells; a cell
names a configuration (``bench/configs/<config>.json``, the file that
``BENCHMARK.json`` gives) and a traffic mix
(``bench/traffic/<traffic>.json``, whose ``driver`` names the module of
``bench/drivers/`` that runs it); ``bench/workloads/<cell>.json`` holds
the cell's comparison with the plain reference and its limits; each
per-layer metric is read by ``bench/metrics/<metric>.py``. A new cell,
mix, configuration or metric is new files and new entries here, never an
edit of a file that exists.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict[str, Any]:
    return load_json(ROOT / "BENCHMARK.json")


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]          # the configuration's file
    traffic_name: str
    traffic: Dict[str, Any]         # the mix's file
    check: Dict[str, Any]           # bench/workloads/<cell>.json
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, spec: Optional[Dict[str, Any]] = None) -> Cell:
    """The cell ``name`` of ``spec`` (``BENCHMARK.json``), its files read,
    with the end-to-end and per-layer metrics it reports."""
    spec = spec if spec is not None else benchmark()
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r}; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    return Cell(
        name=name, chips=int(w["chips"]),
        config=load_json(ROOT / configs[w["config"]]["file"]),
        traffic_name=w["traffic"],
        traffic=load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
        check=load_json(BENCH / "workloads" / f"{name}.json"),
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, name)])


def load_module(path: Path, name: str):
    """The Python file ``path`` as a module (names with dots, such as
    ``mfu.train.py``, cannot be imported by name)."""
    mod_spec = importlib.util.spec_from_file_location(name, path)
    if mod_spec is None or mod_spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(mod_spec)
    sys.modules[name] = mod
    mod_spec.loader.exec_module(mod)
    return mod


def driver(traffic: Dict[str, Any]):
    return load_module(BENCH / "drivers" / f"{traffic['driver']}.py",
                       f"bench_driver_{traffic['driver']}")


def metric_reader(name: str):
    return load_module(BENCH / "metrics" / f"{name}.py",
                       "bench_metric_" + name.replace(".", "_").replace("-", "_"))
