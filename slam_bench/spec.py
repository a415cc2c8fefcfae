"""The benchmark as data: `BENCHMARK.json` at the root of the checkout, and
the files it names by convention under `slam_bench/`:

- a configuration `<config>`: `configs/<config>.json` (its source, what was
  changed from it, the camera and IMU it runs) and the settings YAML that
  file names, which the program reads;
- a traffic mix `<traffic>`: `traffic/<traffic>.json`, the parameters the
  one generator (`scene.py`) reads;
- a cell `<name>`: `cells/<name>.json`, the limits of the correctness
  numbers it compares (`limits`), the highest frame rate (`max_fps`) its
  scene must outlast and, optionally, how the facade runs it (`facade`:
  attributes to `set` once it is built, methods to call `after_warmup`,
  and the `pose_lag` of a tracker that returns each pose that many calls
  late);
- a per-layer metric `<name>`: `metrics/<name>.py`, a reader with NAME,
  UNIT, LAYER, MOVES, the SPANS it times, the CALLS whose arguments it
  reads, and read(trace).

A cell, configuration, traffic mix or metric is added by adding files and
entries; nothing here names one. Every path is taken from the root of the
checkout.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

class Bench:
    def __init__(self, root: Path):
        self.root = Path(root)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dir = self.root / "slam_bench"

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def cell_file(self, cell: str) -> dict:
        """The cell's `limits`, `max_fps` and `facade` options."""
        c = json.loads((self.dir / "cells" / f"{cell}.json").read_text())
        c.setdefault("facade", {})
        return c

    def end_to_end(self, cell: str) -> list:
        """The cell's end-to-end metrics: those without a `workloads` list
        and those that list it."""
        return [m for m in self.data["end_to_end"] if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list:
        """The cell's per-layer metrics: those that list it, and those without
        a list whose `moves` metric the cell reports."""
        moves = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.data["per_layer"]
                if cell in m.get("workloads", ()) or ("workloads" not in m and m["moves"] in moves)]

    def reader(self, name: str):
        """The reader module of per-layer metric `name` (metrics/<name>.py)."""
        path = self.dir / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"slam_bench_metric_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        if mod.NAME != name:
            raise ValueError(f"{path} names itself {mod.NAME!r}")
        return mod
