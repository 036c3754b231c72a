"""The cell ``erb1080-train-b1`` as a benchmark run runs it (set-up, the
window, the check against the reference under the cell's limits), at a
size the CPU runs in seconds: ``tiny.py``'s, with the UVG configuration cut
to a tiny geometry that keeps its stride-3 stage (grid 2x3, strides 5, 3,
2, 60x90 frames).  The unbroken run is ``correct``; each fault planted in
the timed path (``harness/faults.py``) that the cell's limits can see is
not.  The cell compares no sweep PSNR (PERF.md section 2), so a sweep whose
PSNR alone is altered is not among them.
"""

import json
import sys
import time
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent), str(Path(__file__).parent)]

from harness import cell as run_cell  # noqa: E402
from harness.faults import planted  # noqa: E402
from harness.spec import Spec  # noqa: E402
from tiny import tiny_root  # noqa: E402

SEED = 2 ** 31 + 1919
STRIDE3 = {"fc_hw_dim": "2_3_6", "strides": [5, 3, 2]}
STRIDE3_VIDEO = {"frames": 4, "height": 60, "width": 90}
CELL = "erb1080-train-b1"
FAULTS = ["state_unchanged", "loss_altered"]


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tiny")
    folder = tiny_root(tmp)
    path = tmp / "benchmark" / "configs" / "erb-uvg1080p.json"
    cfg = json.loads(path.read_text())
    cfg["model"].update(STRIDE3)
    cfg["video"] = dict(STRIDE3_VIDEO)
    path.write_text(json.dumps(cfg))
    return Spec(tmp, folder)


def run(spec):
    torch.manual_seed(0)
    result, _ = run_cell.run(spec, CELL, SEED, 0.5, False, "cpu", time.perf_counter())
    return result


def test_the_unbroken_run_is_correct(spec):
    result = run(spec)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0


@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(spec, fault):
    with planted(fault):
        result = run(spec)
    assert not result["correct"], result["checks"]
