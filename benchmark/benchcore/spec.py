"""``BENCHMARK.json`` and the files it names.

Everything that belongs to one cell is found by name, never listed here:

* a configuration: the file its entry in ``configs`` names;
* a traffic mix: ``traffic/<traffic>.json``, whose ``driver`` key names
  the driver, ``drivers/<driver>.py`` (``run(ctx) -> record``);
* a per-layer metric: ``metrics/<name>.py`` (``read(record) -> number or
  None``);
* the limits of the comparison that decides ``correct``:
  ``limits/<workload>.json``.

A later change adds a cell as new files plus new entries in
``BENCHMARK.json``; it edits no file here.
"""

from __future__ import annotations

import importlib.util
import json
import os

__all__ = ["BENCH_DIR", "ROOT", "Spec", "load_json", "load_module"]

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """The module in the file ``path``, executed under ``name`` (a file
    name may hold dots, as a metric's does)."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Spec:
    """``BENCHMARK.json`` at ``root`` and the benchmark's files under
    ``root``/``bench_dir``."""

    def __init__(self, root: str = ROOT, bench_dir: str | None = None):
        self.root = root
        self.bench_dir = bench_dir or os.path.join(root, "benchmark")
        self.doc = load_json(os.path.join(root, "BENCHMARK.json"))

    def _named(self, key: str, name: str) -> dict:
        for entry in self.doc[key]:
            if entry["name"] == name:
                return entry
        known = ", ".join(e["name"] for e in self.doc[key])
        raise KeyError(f"no {key[:-1] if key.endswith('s') else key} named "
                       f"{name!r} in BENCHMARK.json (known: {known})")

    def cell(self, name: str) -> dict:
        return self._named("workloads", name)

    def config(self, cell: dict) -> dict:
        entry = self._named("configs", cell["config"])
        return load_json(os.path.join(self.root, entry["file"]))

    def traffic(self, cell: dict) -> dict:
        return load_json(os.path.join(self.bench_dir, "traffic",
                                      cell["traffic"] + ".json"))

    def driver(self, mix: dict):
        name = mix["driver"]
        return load_module(os.path.join(self.bench_dir, "drivers",
                                        name + ".py"), f"bench_driver_{name}")

    def limits(self, cell: dict) -> dict:
        return load_json(os.path.join(self.bench_dir, "limits",
                                      cell["name"] + ".json"))

    def _applies(self, metric: dict, cell: dict, among: list) -> bool:
        listed = metric.get("workloads")
        if listed is not None:
            return cell["name"] in listed
        # without a list: every cell that reports the metric it moves
        moves = metric.get("moves")
        return moves is None or any(m["name"] == moves for m in among)

    def end_to_end(self, cell: dict) -> list:
        return [m for m in self.doc["end_to_end"]
                if self._applies(m, cell, [])]

    def per_layer(self, cell: dict) -> list:
        e2e = self.end_to_end(cell)
        return [m for m in self.doc["per_layer"] if self._applies(m, cell, e2e)]

    def reader(self, metric: dict):
        name = metric["name"]
        return load_module(os.path.join(self.bench_dir, "metrics",
                                        name + ".py"),
                           "bench_metric_" + name.replace(".", "_"))
