"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of
the checkout, a cell's configuration file, its traffic mix
(``traffic/<name>.json``), the loop the mix names (``loops/<loop>.py``),
its limits (``limits/<cell>.json``) and the reader of each per-layer
metric (``metrics/<name>.py``)."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


class Benchmark:
    def __init__(self, path: Path) -> None:
        self.path = path
        self.root = path.parent
        self.data = json.loads(path.read_text())

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload named {name!r} in {self.path}")

    def config(self, cell: dict) -> dict:
        for c in self.data["configs"]:
            if c["name"] == cell["config"]:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config named {cell['config']!r}")

    def end_to_end(self, cell: dict) -> list[dict]:
        """The end-to-end metrics the cell reports."""
        return [m for m in self.data["end_to_end"]
                if cell["name"] in m.get("workloads", [cell["name"]])]

    def per_layer(self, cell: dict) -> list[dict]:
        """The per-layer metrics the cell reports: those that list it, and
        those without a list that move an end-to-end metric it reports."""
        moved = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.data["per_layer"]
                if (cell["name"] in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def traffic(root: Path, name: str) -> dict:
    return json.loads((root / "traffic" / f"{name}.json").read_text())


def _load(path: Path, prefix: str):
    name = prefix + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def loop(root: Path, name: str):
    """The module ``loops/<name>.py``: its ``measure(run)`` and
    ``control(run)``."""
    return _load(root / "loops" / f"{name}.py", "rtbench_loop_")


def reader(root: Path, metric: str):
    """The ``read(context)`` function of ``metrics/<metric>.py``."""
    return _load(root / "metrics" / f"{metric}.py", "rtbench_metric_").read
