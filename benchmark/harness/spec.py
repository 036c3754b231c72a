"""Finding a cell's parts by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix; the
rest is found by file name under the benchmark's folder, so that a new
configuration, mix, per-layer metric or cell is a new file and no edit:

* a configuration: the ``file`` its entry in ``BENCHMARK.json`` names;
* a traffic mix: ``traffic/<mix>.json``, whose ``kind`` names its driver;
* a traffic driver: ``drivers/<kind>.py``, whose ``Mix(cfg, traffic, seed,
  device)`` sets up, runs the window or its traced slice, and checks;
* a per-layer metric: ``metrics/<metric>.py``, whose ``read(ctx)`` returns
  the value or None when the run holds nothing to read;
* a cell's limits on the numbers its check compares: ``limits/<cell>.json``.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parents[1]  # the benchmark's folder
ROOT = HERE.parent  # the checkout


class Spec:
    """``BENCHMARK.json`` at ``root`` and the benchmark folder ``folder``."""

    def __init__(self, root: Path = ROOT, folder: Path = HERE):
        self.root, self.folder = Path(root), Path(folder)
        with open(self.root / "BENCHMARK.json") as f:
            self.bench = json.load(f)

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                with open(self.root / c["file"]) as f:
                    return json.load(f)
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        with open(self.folder / "traffic" / f"{name}.json") as f:
            return json.load(f)

    def limits(self, cell: str) -> Dict[str, float]:
        with open(self.folder / "limits" / f"{cell}.json") as f:
            return json.load(f)["limits"]

    def metrics(self, cell: str, trace: bool) -> List[dict]:
        """The cell's end-to-end metrics (``trace`` False) or per-layer ones."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]

    def driver(self, kind: str) -> type:
        """The ``Mix`` class of the traffic kind ``kind``."""
        return _load(self.folder / "drivers" / f"{kind}.py", "bench_driver_" + kind).Mix

    def reader(self, metric: str) -> Callable[[dict], Optional[float]]:
        return _load(self.folder / "metrics" / f"{metric}.py", "bench_metric_" + metric).read


def _load(path: Path, name: str):
    """The module of the file ``path``, loaded under ``name`` (made an
    identifier)."""
    spec = importlib.util.spec_from_file_location(re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
