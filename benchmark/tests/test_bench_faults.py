"""A run with the timed path broken underneath reads ``correct`` false.

Each cell runs as a benchmark run does (set-up, the window, the check
against the reference under the cell's own limits), at the tiny size of
``tiny.py`` on the CPU, once unbroken and once with each fault the cell can
have planted in the program (``harness/faults.py``).
"""

import sys
import time
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent), str(Path(__file__).parent)]

from harness import cell as run_cell  # noqa: E402
from harness.faults import FAULTS, planted  # noqa: E402
from harness.spec import Spec  # noqa: E402
from tiny import tiny_root  # noqa: E402

SEED = 2 ** 31 + 77
KIND = {"erb720-train-b1": "train", "vanilla720-train-b1": "train",
        "erb720-decode-bf16": "decode", "erb720-decode-int8": "decode"}
CASES = [(c, f) for c in KIND for f, (kind, _, _) in FAULTS.items() if kind == KIND[c]]


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tiny")
    return Spec(tmp, tiny_root(tmp))


def run(spec, workload):
    torch.manual_seed(0)
    result, _ = run_cell.run(spec, workload, SEED, 0.5, False, "cpu", time.perf_counter())
    return result


@pytest.mark.parametrize("workload", sorted(KIND))
def test_the_unbroken_run_is_correct(spec, workload):
    result = run(spec, workload)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("workload, fault", CASES)
def test_a_broken_timed_path_is_not_correct(spec, workload, fault):
    with planted(fault):
        result = run(spec, workload)
    assert not result["correct"], result["checks"]
