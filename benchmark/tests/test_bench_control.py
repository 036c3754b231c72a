"""On the card, at each cell's own size: the program passes its cell's
limits and the control does not.  The control is the reference one
precision below what the configuration states, put in the program's place:
fp8 (e4m3, one scale a tensor) for bf16, and an int4 tail for the int8
tail.  Three seeds a cell; a decode cell first serves a one-second window,
a training cell trains until the window's first val sweep.

    python -m pytest -p no:cacheprovider -m gpu benchmark/tests/test_bench_control.py
"""

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent)]

from harness.checks import verdict  # noqa: E402
from harness.spec import Spec  # noqa: E402

# the window: a training cell's reaches its first val sweep (25 epochs)
CELLS = {"erb720-train-b1": 16.0, "erb720-decode-bf16": 1.0, "vanilla720-train-b1": 16.0,
         "erb720-decode-int8": 1.0}
SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", sorted(CELLS))
def test_the_control_fails_where_the_program_passes(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's own size")
    from readings import collect

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = Spec()
    limits = spec.limits(workload)
    for row in collect(spec, workload, SEEDS, CELLS[workload], control=True):
        assert verdict(row["program"], limits), row
        assert not verdict(row["control"], limits), row
