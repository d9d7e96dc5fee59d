"""Finding a cell's pieces by name: ``BENCHMARK.json`` at the checkout's
root, ``configs/<config>.json``, ``traffic/<traffic>.json`` and
``metrics/<metric>.py`` under ``solverbench/``.  Adding a configuration, a
traffic mix or a metric adds files and entries; no code here names one.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    data_dir: str  # the solverbench/ folder the pieces were read from

    def path(self, *parts) -> str:
        return os.path.join(self.data_dir, *parts)


class Bench:
    """``BENCHMARK.json`` under ``root`` and the data files beside it."""

    def __init__(self, root: str = ROOT):
        self.data_dir = os.path.join(root, "solverbench")
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.spec = json.load(f)

    def _json(self, *parts) -> dict:
        with open(os.path.join(self.data_dir, *parts)) as f:
            return json.load(f)

    def cell(self, name: str) -> Cell:
        cells = {w["name"]: w for w in self.spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; workloads: {sorted(cells)}")
        w = cells[name]
        return Cell(name, int(w["chips"]), self._json("configs", w["config"] + ".json"),
                    self._json("traffic", w["traffic"] + ".json"), self.data_dir)

    def metrics(self, cell: str, traced: bool) -> list[dict]:
        """The metrics a run of ``cell`` reports: the end-to-end ones with
        ``--trace 0`` (those with a ``workloads`` list in its cells alone),
        with ``--trace 1`` the per-layer ones whose ``workloads`` list names
        it."""
        if not traced:
            return [m for m in self.spec["end_to_end"] if cell in m.get("workloads", [cell])]
        return [m for m in self.spec["per_layer"] if cell in m["workloads"]]

    def reader(self, metric: str):
        """``read(run)`` of ``metrics/<metric>.py``."""
        path = os.path.join(self.data_dir, "metrics", metric + ".py")
        spec = importlib.util.spec_from_file_location(f"solverbench_metric_{metric}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def problem_module(config: dict):
    """The plain reference's statement of the configuration's problem,
    ``solverbench/reference/<reference>.py``."""
    return importlib.import_module("solverbench.reference." + config["reference"])
