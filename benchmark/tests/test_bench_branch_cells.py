"""A cell of another branch type is new files only.

For DBB and ECB, under the ``train-b1`` and ``decode-b8`` mixes, a
``tiny_root`` copy gains what a configuration's PR would add: the
configuration's file (the tiny flagship with that ``branch_type``), its
entry in ``BENCHMARK.json``, the cell's entry (and its name in the lists of
the end-to-end metrics its mix reports) and the cell's limits file (the ERB
cell's of the same mix).  No file of the benchmark changes.  The cell runs
as a benchmark run runs it (``harness/cell.run``: set-up, the window, the
check against the reference under its limits), on the CPU, and is
``correct``; in training, each fault planted in the timed path that such a
cell can have (``harness/faults.py``) makes it not correct.
"""

import json
import shutil
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

SEED = 2 ** 31 + 2311
CONFIGS = {"DBB": "dbb-720p", "ECB": "ecb-720p"}  # branch type -> configuration
MIXES = {"train-b1": "erb720-train-b1", "decode-b8": "erb720-decode-bf16"}  # -> the ERB cell
CELLS = {erb.replace("erb", branch.lower()): (branch, mix, erb)
         for branch in CONFIGS for mix, erb in MIXES.items()}
FAULTS = ["state_unchanged", "loss_altered"]


def files(folder: Path) -> dict:
    return {p.relative_to(folder): p.read_bytes() for p in folder.rglob("*") if p.is_file()}


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tiny")
    folder = tiny_root(tmp)
    before = files(folder)
    bench = json.loads((tmp / "BENCHMARK.json").read_text())
    erb = json.loads((tmp / "benchmark" / "configs" / "erb-720p.json").read_text())
    for branch, name in CONFIGS.items():
        file = f"benchmark/configs/{name}.json"
        (tmp / file).write_text(json.dumps({**erb, "model": {**erb["model"],
                                                             "branch_type": branch}}))
        bench["configs"].append({"name": name, "source": "https://arxiv.org/abs/2511.11071",
                                 "file": file, "reduced": [], "why": f"{branch} branches"})
    for cell, (branch, mix, erb_cell) in CELLS.items():
        bench["workloads"].append({"name": cell, "config": CONFIGS[branch], "traffic": mix,
                                   "chips": 1, "why": f"{branch} under {mix}"})
        for m in bench["end_to_end"]:
            if erb_cell in m.get("workloads", []):
                m["workloads"].append(cell)
        shutil.copy(folder / "limits" / f"{erb_cell}.json", folder / "limits" / f"{cell}.json")
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    after = files(folder)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {Path("configs", f"{n}.json") for n in CONFIGS.values()} | {
        Path("limits", f"{c}.json") for c in CELLS}
    return Spec(tmp, folder)


def run(spec, cell):
    torch.manual_seed(0)
    result, _ = run_cell.run(spec, cell, SEED, 0.5, False, "cpu", time.perf_counter())
    return result


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_added_cell_runs_correct(spec, cell):
    result = run(spec, cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0
    want = {m["name"] for m in spec.metrics(cell, trace=False)}
    assert set(result["metrics"]) == want and len(want) == (2 if "train" in cell else 3)


@pytest.mark.parametrize("cell, fault", [(c, f) for c in sorted(CELLS) if "train" in c
                                         for f in FAULTS])
def test_a_broken_timed_path_is_not_correct(spec, cell, fault):
    with planted(fault):
        result = run(spec, cell)
    assert not result["correct"], result["checks"]
