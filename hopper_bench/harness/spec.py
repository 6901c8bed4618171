"""BENCHMARK.json and the files it names, found by name.

  configs/<config>.json         a configuration (entry "file" in configs)
  traffic/<traffic>.json        a traffic mix; its "kind" names its driver
  metrics/<metric>.py           the reader of a per-layer metric
  limits/<workload>.json        the limits of the cell's `correct`

A later cell, mix or metric adds files and entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = ROOT / "hopper_bench"


def load_benchmark(root: Path = ROOT):
    return json.loads((root / "BENCHMARK.json").read_text())


def _json(path: Path):
    return json.loads(path.read_text())


def traffic_path(name: str) -> Path:
    return BENCH_DIR / "traffic" / f"{name}.json"


def reader_path(metric: str) -> Path:
    return BENCH_DIR / "metrics" / f"{metric}.py"


def limits_path(workload: str) -> Path:
    return BENCH_DIR / "limits" / f"{workload}.json"


def load_reader(metric: str):
    """The `read(ctx)` function of metrics/<metric>.py."""
    path = reader_path(metric)
    spec = importlib.util.spec_from_file_location(f"hopper_bench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metrics_of(entries, workload: str):
    """The metrics of `entries` that the cell reports: those that list it,
    and those that list no cells."""
    return [m for m in entries if workload in m.get("workloads", [workload])]


class Cell:
    """One workload of BENCHMARK.json with everything it names."""

    def __init__(self, bench: dict, workload: str):
        entries = {w["name"]: w for w in bench["workloads"]}
        if workload not in entries:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                           f"(there are {sorted(entries)})")
        self.name = workload
        self.entry = entries[workload]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = _json(ROOT / configs[self.entry["config"]]["file"])
        self.traffic = _json(traffic_path(self.entry["traffic"]))
        self.limits = _json(limits_path(workload))
        self.chips = int(self.entry["chips"])
        self.end_to_end = metrics_of(bench["end_to_end"], workload)
        self.per_layer = metrics_of(bench["per_layer"], workload)
