"""Run one cell of the PyTorch port's benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It makes the cell's inputs on the card from
the seed, warms up the cell's shapes (set-up), runs the cell's traffic for
``--seconds`` (``--trace 0``: the end-to-end metrics) or a short traced
slice of it (``--trace 1``: the per-layer metrics), checks what the timed
path produced against the plain reference in ``benchmark/reference``, and
prints the result as one JSON line, last on standard output; the numbers
the check compared, each beside its limit, are the last lines of standard
error.  It exits with 1, and prints no result, without a CUDA device or
with fewer than the cell asks for, or when JAX or the JAX package was
loaded.  The cells, configurations, traffic mixes and metrics are named in
``BENCHMARK.json`` and found by file name (``harness/spec.py``).
"""

import time

STARTED = time.perf_counter()  # set-up counts from here: imports and all

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(msg: str) -> int:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    return 1


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from harness.spec import Spec

    t_torch = time.perf_counter() - STARTED

    spec = Spec()
    chips = spec.cell(args.workload)["chips"]
    if not torch.cuda.is_available():
        return fail("no CUDA device: the benchmark measures the card and never the CPU")
    if torch.cuda.device_count() < chips:
        return fail(f"{args.workload} needs {chips} CUDA devices, "
                    f"{torch.cuda.device_count()} are visible")
    from harness.cell import forbidden_modules, run, smi_name_power

    smi = smi_name_power()
    print(f"card: {smi}", file=sys.stderr, flush=True)
    # full-f32 convs and matmuls wherever f32 runs, as the port's CLIs set it
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_program = time.perf_counter() - STARTED - t_torch
    result, parts = run(spec, args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                        STARTED)
    found = forbidden_modules()
    if found:
        return fail(f"the process loaded {', '.join(found)}: the port and the benchmark run "
                    "without JAX and without the JAX package")
    name, _, limit = smi.partition(",")
    result["device"]["power_limit"] = limit.strip()
    parts = {"import_torch": t_torch, "import_program_and_card_name": t_program, **parts}
    print("setup parts: " + json.dumps({k: round(v, 4) for k, v in parts.items()}),
          file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
