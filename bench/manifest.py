"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of
the checkout, each configuration's file (``bench/configs/<config>.json``),
each traffic mix (``bench/traffic/<mix>.json``), each cell's limits
(``bench/limits/<cell>.json``) and each per-layer metric's reader
(``bench/metrics/<metric>.py``, a function ``read(ctx)`` that returns a
number or None).  A later cell, mix, configuration or metric is new
files and new entries; no code here names one.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def load_json(path: Path) -> Dict:
    with open(path) as fh:
        return json.load(fh)


class Manifest:
    """``BENCHMARK.json`` and the files its names lead to, under ``root``
    (the checkout) and ``bench`` (the benchmark's folder in it)."""

    def __init__(self, root: Path = ROOT, bench: Optional[Path] = None):
        self.root = Path(root)
        self.bench = Path(bench) if bench is not None else self.root / "bench"
        self.doc = load_json(self.root / "BENCHMARK.json")

    def cell(self, name: str) -> Dict:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{[w['name'] for w in self.doc['workloads']]}")

    def config(self, name: str) -> Dict:
        entry = next((c for c in self.doc["configs"] if c["name"] == name),
                     None)
        if entry is None:
            raise KeyError(f"no config {name!r} in BENCHMARK.json")
        return load_json(self.root / entry["file"])

    def traffic(self, name: str) -> Dict:
        return load_json(self.bench / "traffic" / f"{name}.json")

    def limits(self, cell: str) -> Dict:
        return load_json(self.bench / "limits" / f"{cell}.json")

    def end_to_end(self, cell: str) -> List[Dict]:
        return [m for m in self.doc["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> List[Dict]:
        return [m for m in self.doc["per_layer"]
                if cell in m.get("workloads", [cell])]

    def reader(self, metric: str) -> Callable[[Dict], Optional[float]]:
        """The ``read`` function of ``bench/metrics/<metric>.py``."""
        path = self.bench / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "bench_metric_" + metric.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
