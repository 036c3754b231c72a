"""The readings that a cell's limits are set from: for each seed, the
numbers the check compares for the program (after set-up and a short
window: set-up's steps and the window's first val sweep, or the window's
requests) and, with ``--control``, for the control, the
reference one precision below the configuration's in the program's place
(fp8 for bf16, an int4 tail for int8); with ``--fault``, for the program
with that fault planted (``harness/faults.py``).  One process for all the
seeds.

    python3 benchmark/readings.py --workload <cell> --seeds 1 2 3 [--window 15] \
        [--control] [--fault <name>]

One JSON line a seed on standard output.  Not part of a benchmark run.
"""

import argparse
import contextlib
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]


def collect(spec, workload: str, seeds, window_s: float, control: bool, device="cuda",
            leaves: bool = False):
    """Yield {"seed", "program", ["control"]} for each seed."""
    import gc

    import torch

    cell = spec.cell(workload)
    cfg, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    for seed in seeds:
        mix = spec.driver(traffic["kind"])(cfg, traffic, seed, device)
        mix.setup()
        mix.window(window_s)
        mix.release()
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        row = {"seed": seed, "program": mix.check()}
        if leaves and hasattr(mix, "leaves"):
            row["program_leaves"] = mix.leaves
        if control:
            row["control"] = mix.check("fp8")
            if leaves and hasattr(mix, "leaves"):
                row["control_leaves"] = mix.leaves
        yield row
        del mix


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--window", type=float, default=2.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default=None)
    p.add_argument("--leaves", action="store_true", help="each leaf's gaps too (training)")
    a = p.parse_args(argv)
    import torch

    from harness.spec import Spec

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from harness.faults import planted

    with planted(a.fault) if a.fault else contextlib.nullcontext():
        for row in collect(Spec(), a.workload, a.seeds, a.window, a.control,
                           leaves=a.leaves):
            print(json.dumps({"fault": a.fault, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
