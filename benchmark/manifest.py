"""Finds what a cell of `BENCHMARK.json` needs by name: its configuration
(`configs/<name>.json`), its traffic mix (`traffic/<name>.json`), the
driver the mix names (`drivers/<name>.py`), the reference the
configuration names (`reference/<name>.py`), its limits
(`limits/<config>.json`) and the reader of each metric it reports
(`metrics/<name>.py`). Adding a cell, a configuration, a mix or a metric
adds files and entries; no file here changes."""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))


class Bench:
    """The manifest at `root` (a checkout) and the files beside it in
    `root/benchmark`."""

    def __init__(self, root: str | None = None):
        self.root = root or os.path.dirname(BENCH_DIR)
        self.dir = os.path.join(self.root, "benchmark")
        with open(os.path.join(self.root, "BENCHMARK.json")) as f:
            self.manifest = json.load(f)

    def _json(self, kind: str, name: str) -> dict:
        with open(os.path.join(self.dir, kind, f"{name}.json")) as f:
            return json.load(f)

    def _module(self, kind: str, name: str):
        path = os.path.join(self.dir, kind, f"{name}.py")
        key = f"benchmark_{kind}_{name}_{abs(hash(path))}"
        if key not in sys.modules:
            spec = importlib.util.spec_from_file_location(key, path)
            if spec is None:
                raise FileNotFoundError(path)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[key] = mod
            spec.loader.exec_module(mod)
        return sys.modules[key]

    def cell(self, name: str) -> dict:
        for w in self.manifest["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def limits(self, config: str) -> dict:
        return self._json("limits", config)

    def driver(self, name: str):
        return self._module("drivers", name)

    def reference(self, name: str):
        # a package module: references share their tables and comparison
        return importlib.import_module(f"benchmark.reference.{name}")

    def reader(self, metric: str):
        return self._module("metrics", metric)

    def metrics(self, cell: str, trace: bool) -> list:
        """The metric entries a run of `cell` reports: end-to-end ones
        untraced, per-layer ones traced."""
        group = self.manifest["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if "workloads" not in m or cell in m["workloads"]]
