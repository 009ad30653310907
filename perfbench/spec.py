"""Finding the benchmark's pieces by name.

``BENCHMARK.json`` names the configurations, cells and metrics; each is a
file of its own:

  * ``configs/<config>.json``   the model's sizes, as run;
  * ``workloads/<cell>.json``   the cell's traffic and output-check limits;
  * ``metrics/<metric>.py``     one reader per metric, ``read(ctx)``;
  * ``models/<arch>.py``, ``streams/<kind>.py``, ``reference/<arch>.py``
    the code that a configuration's ``arch`` and a cell's stream ``kind``
    name.

A later cell, configuration or metric is a new file here and a new entry
in ``BENCHMARK.json``; no file that is already here changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Bench:
    """``BENCHMARK.json`` and the files it names, under the checkout
    ``root`` (the folder that holds ``BENCHMARK.json``)."""

    def __init__(self, root: Path, here: Path = HERE):
        self.root = Path(root)
        self.here = Path(here)
        self.spec = load_json(self.root / "BENCHMARK.json")

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return load_json(self.root / c["file"])
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def workload(self, name: str) -> dict:
        return load_json(self.here / "workloads" / f"{name}.json")

    def end_to_end(self, cell: str) -> list[dict]:
        """The end-to-end metrics that ``cell`` reports."""
        return [m for m in self.spec["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list[dict]:
        """The per-layer metrics that ``cell`` reports: those that list it,
        and those without a list whose end-to-end metric it reports."""
        moves = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.spec["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in moves)]

    def reader(self, metric: str):
        """``metrics/<metric>.py``'s ``read``; a metric's name may hold a
        dot, so the file is loaded by its path."""
        path = self.here / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            f"perfbench_metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def part(kind: str, name: str):
    """``perfbench.<kind>.<name>``: the module of an architecture
    (``models``, ``reference``) or of a stream (``streams``)."""
    return importlib.import_module(f"perfbench.{kind}.{name}")
