"""Everything a cell needs, found by the names in BENCHMARK.json: the cell's
workload file, its configuration file, its entry module and the per-layer
metric readers. Nothing here names a cell, a configuration or a metric."""
from __future__ import annotations

import copy
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parent.parent  # portbench/
ROOT = BENCH.parent  # the checkout


def merge(base: dict, over: Optional[dict]) -> dict:
    """`base` with `over`'s keys replaced, recursively into dicts."""
    out = copy.deepcopy(base)
    for k, v in (over or {}).items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else copy.deepcopy(v)
    return out


class Cell:
    """One workload of BENCHMARK.json with its files."""

    def __init__(self, name: str, manifest: Optional[dict] = None, overrides: Optional[dict] = None):
        self.manifest = manifest if manifest is not None else load_manifest()
        entry = next((w for w in self.manifest["workloads"] if w["name"] == name), None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name, self.chips = name, int(entry["chips"])
        config = next(c for c in self.manifest["configs"] if c["name"] == entry["config"])
        overrides = overrides or {}
        self.spec = merge(json.loads((BENCH / "workloads" / f"{name}.json").read_text()), overrides.get("cell"))
        self.config = merge(json.loads((ROOT / config["file"]).read_text()), overrides.get("config"))
        self.entry = importlib.import_module(f"portbench.entries.{self.spec['entry']}")

    def end_to_end(self) -> List[dict]:
        return [m for m in self.manifest["end_to_end"] if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> List[dict]:
        moved = {m["name"] for m in self.end_to_end()}
        return [m for m in self.manifest["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def load_manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def reader(metric: str):
    """The module `portbench/metrics/<metric>.py` (metric names hold dots, so
    it is loaded by its path)."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def counters_of(readers: Dict[str, object]) -> Dict[str, tuple]:
    """{counter name: (module, attribute)} that the readers ask for."""
    out = {}
    for module in readers.values():
        out.update(getattr(module, "COUNTERS", {}))
    return out
