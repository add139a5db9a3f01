"""Everything a cell needs, found by the names in ``BENCHMARK.json``.

A cell names a configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<mix>.json``); its correctness limits sit in
``limits/<cell>.json``; each per-layer metric is a reader
``metrics/<metric>.py`` with a ``read(ctx)`` that returns a number or None.
Adding a cell, configuration, mix or metric adds files and entries; no file
here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json", encoding="utf-8") as fh:
        return json.load(fh)


def _json(path: Path) -> dict:
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


class Cell:
    """One workload of ``BENCHMARK.json`` with its files loaded."""

    def __init__(self, name: str, bench: dict = None):
        bench = bench or benchmark()
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = cells[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config_file = _json(ROOT / self.config_entry["file"])
        self.config = self.config_file["config"]
        self.mix = _json(HERE / "traffic" / f"{self.entry['traffic']}.json")
        self.limits = _json(HERE / "limits" / f"{name}.json")
        self.end_to_end = [m for m in bench["end_to_end"] if _reports(m, name)]
        self.per_layer = [m for m in bench["per_layer"] if _reports(m, name)]

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def reader(metric: str) -> Callable:
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
