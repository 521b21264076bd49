"""Everything a run needs, found by name from ``BENCHMARK.json``.

A cell ``<name>`` is the entry of ``workloads`` with that name; beside it

  benchmark/workloads/<name>.json     the cell's limits for ``correct`` and
                                      the readings they were set from
  benchmark/traffic/<traffic>.json    the traffic mix's parameters
  <config file>                       the configuration as it is run; its
                                      ``family`` names the two below
  benchmark/families/<family>.py      how to build and step the program
  benchmark/reference/<family>.py     the plain reference
  benchmark/metrics/<metric>.py       one reader a per-layer metric

so that a new cell, configuration, traffic mix or metric is new files and
new entries, never an edit to a file that is there.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, NamedTuple

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


class Cell(NamedTuple):
    name: str
    entry: Dict          # the workload's entry in BENCHMARK.json
    config: Dict         # the configuration's file
    config_entry: Dict   # its entry in BENCHMARK.json
    traffic: Dict        # the traffic mix's parameters
    limits: Dict         # the workload file
    end_to_end: List[Dict]   # the end-to-end metrics this cell reports
    per_layer: List[Dict]    # the per-layer metrics this cell reports


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> Dict:
    return load_json(root / "BENCHMARK.json")


def _reports(metric: Dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    # a per-layer metric without the key is read in every cell that
    # reports the end-to-end metric it moves
    return e2e_names is None or metric.get("moves") in e2e_names


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = root / "benchmark"
    m = manifest(root)
    entries = {w["name"]: w for w in m["workloads"]}
    if name not in entries:
        raise KeyError("no workload {!r} in BENCHMARK.json (have {})".format(
            name, ", ".join(sorted(entries))))
    entry = entries[name]
    configs = {c["name"]: c for c in m["configs"]}
    config_entry = configs[entry["config"]]
    config = load_json(root / config_entry["file"])
    traffic = load_json(bench / "traffic" / (entry["traffic"] + ".json"))
    limits = load_json(bench / "workloads" / (name + ".json"))
    e2e = [x for x in m["end_to_end"] if _reports(x, name, None)]
    e2e_names = {x["name"] for x in e2e}
    per_layer = [x for x in m["per_layer"] if _reports(x, name, e2e_names)]
    return Cell(name, entry, config, config_entry, traffic, limits, e2e,
                per_layer)


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise ImportError("cannot load {}".format(path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def family_module(cell: Cell) -> ModuleType:
    """``benchmark/families/<family>.py`` (``benchmark/`` is on the path)."""
    return importlib.import_module("families." + cell.config["family"])


def metric_reader(name: str, root: Path = ROOT) -> ModuleType:
    return load_module(root / "benchmark" / "metrics" / (name + ".py"),
                       "bench_metric_" + name.replace(".", "_"))
