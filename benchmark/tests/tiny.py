"""A copy of the benchmark at a size the CPU runs in seconds, for the tests:
the real traffic mixes, their drivers, metric readers and limits, and each configuration
cut to a few pixels and channels (the shapes' kinds kept) and run in f32."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
REPO = HERE.parent

# f32: on the CPU the port's bf16 runs its plain path, which rounds after
# every op and reads further from the reference than the card's kernels do
TINY_MODEL = {"embed": "1.25_4", "stem_dim_num": "16_1", "fc_hw_dim": "3_4_6", "expansion": 1,
              "reduction": 2, "strides": [2, 2, 2], "lower_width": 4,
              "compute_dtype": "float32"}
TINY_VIDEO = {"frames": 4, "height": 24, "width": 32}


def tiny_root(tmp: Path) -> Path:
    """``tmp`` as a checkout root holding the tiny benchmark: returns the
    benchmark folder."""
    folder = tmp / "benchmark"
    for sub in ("traffic", "drivers", "metrics", "limits"):
        shutil.copytree(HERE / sub, folder / sub)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    (folder / "configs").mkdir()
    for c in bench["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        cfg["model"].update(TINY_MODEL)
        cfg["video"] = dict(TINY_VIDEO)
        c["file"] = f"benchmark/configs/{c['name']}.json"
        (tmp / c["file"]).write_text(json.dumps(cfg))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return folder
