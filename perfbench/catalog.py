"""Finds what ``BENCHMARK.json`` names: a cell's workload file, its
configuration, its traffic mix and each metric's reader, all by name, so
that a new cell or metric is a new file and no edit.

- ``workloads/<cell>.json``: the cell's LS rate, limits, pre-roll, drain
  cap, profiled sub-window and the limits of its output check;
- ``traffic/<mix>.json``: LS prompt and output lengths, the BE backlog's;
- the configuration's ``file`` as ``BENCHMARK.json`` gives it: both
  tenants' models, slot pools and the engine's settings;
- ``metrics/<metric>.py``: a function ``read(run)`` that returns the
  metric's value, or None where the run holds nothing to read.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List


METRICS = Path(__file__).resolve().parent / "metrics"


def load_reader(name: str, directory: Path = METRICS):
    """The ``read`` function of ``<directory>/<name>.py``."""
    path = Path(directory) / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Catalog:
    def __init__(self, root: Path):
        self.root = Path(root)                 # the repository's root
        self.here = self.root / "perfbench"
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        self._readers: Dict[str, object] = {}

    def _entry(self, key: str, name: str) -> dict:
        for e in self.bench[key]:
            if e["name"] == name:
                return e
        raise KeyError(f"no {key[:-1]} named {name!r} in BENCHMARK.json")

    def cell(self, name: str) -> dict:
        """BENCHMARK.json's entry of the cell, with its workload file's
        keys under ``"cell"``."""
        e = dict(self._entry("workloads", name))
        e["cell"] = json.loads(
            (self.here / "workloads" / f"{name}.json").read_text())
        return e

    def config(self, name: str) -> dict:
        return json.loads(
            (self.root / self._entry("configs", name)["file"]).read_text())

    def traffic(self, name: str) -> dict:
        return json.loads(
            (self.here / "traffic" / f"{name}.json").read_text())

    def metrics(self, cell: str, trace: bool) -> List[dict]:
        """The metrics a run of ``cell`` reports: the end-to-end ones with
        ``trace`` off, the per-layer ones with it on; a metric with a
        ``workloads`` list only in those cells."""
        return [m for m in self.bench["per_layer" if trace else "end_to_end"]
                if cell in m.get("workloads", [cell])]

    def reader(self, name: str):
        """The ``read`` function of ``metrics/<name>.py``."""
        if name not in self._readers:
            self._readers[name] = load_reader(name, self.here / "metrics")
        return self._readers[name]
