"""Finding a cell, its configuration, its traffic mix and its per-layer
metrics by name.

Everything a cell needs is a file of its own under the benchmark's folder:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``limits/<cell>.json`` and ``metrics/<metric>.py``; ``BENCHMARK.json`` at
the checkout's root names the cells and the metrics. A new cell is new
files and entries, never an edit of this module.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent.parent      # the benchmark's folder
ROOT = HERE.parent                                  # the checkout


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: List[dict]      # the end-to-end metrics this cell reports
    per_layer: List[dict]       # the per-layer metrics this cell reports
    bench_dir: Path

    @property
    def assumed(self) -> dict:
        return self.config.get("assumed", {})

    def reader(self, metric: str) -> Callable[[dict], Optional[float]]:
        return load_reader(self.bench_dir, metric)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(name: str, root: Path = ROOT,
              bench_dir: Optional[Path] = None) -> Cell:
    """The cell `name` of ``<root>/BENCHMARK.json`` with its files, read
    from `bench_dir` (the benchmark's folder, by default this one)."""
    bench_dir = HERE if bench_dir is None else Path(bench_dir)
    spec = load_json(Path(root) / "BENCHMARK.json")
    for w in spec["workloads"]:
        if w["name"] == name:
            break
    else:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                       f"{[w['name'] for w in spec['workloads']]}")
    config = load_json(bench_dir / "configs" / f"{w['config']}.json")
    traffic = load_json(bench_dir / "traffic" / f"{w['traffic']}.json")
    limits_path = bench_dir / "limits" / f"{name}.json"
    limits = load_json(limits_path) if limits_path.exists() else {}
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"],
                config=config, traffic_name=w["traffic"], traffic=traffic,
                limits=limits,
                end_to_end=[m for m in spec["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in spec["per_layer"] if _reports(m, name)],
                bench_dir=bench_dir)


def load_reader(bench_dir: Path, metric: str
                ) -> Callable[[dict], Optional[float]]:
    """``metrics/<metric>.py``'s ``read(run) -> float | None``."""
    path = Path(bench_dir) / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"_bench_metric_{metric.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def read_metrics(cell: Cell, run: dict) -> Dict[str, dict]:
    """Every per-layer metric of `cell` that its reader finds in `run`
    (a reader that finds nothing returns None, and the metric is left
    out)."""
    out = {}
    for m in cell.per_layer:
        value = cell.reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
