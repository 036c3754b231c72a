"""One run of one cell: set-up, the window (or, traced, its slice), the
check against the reference, and the result line's content."""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

from .checks import verdict
from .spec import Spec

# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "repnerv_tpu")


def forbidden_modules() -> list:
    """The forbidden top-level names in ``sys.modules``, each compared whole
    (``repnerv_tpu_torch`` is not ``repnerv_tpu``)."""
    loaded = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(loaded.intersection(FORBIDDEN))


def smi_name_power() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def run(spec: Spec, workload: str, seed: int, seconds: float, traced: bool, device,
        started: float) -> tuple:
    """Run ``workload`` once; returns the result line's keys (``checks``
    last) and the set-up's split into parts (seconds by name)."""
    cell = spec.cell(workload)
    cfg, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    limits = spec.limits(workload)
    device = torch.device(device)
    mix = spec.driver(traffic["kind"])(cfg, traffic, seed, device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    mix.setup()
    setup_s = time.perf_counter() - started
    if traced:
        d = tempfile.mkdtemp(prefix="bench-trace-")  # under TMPDIR
        try:
            ctx = mix.traced(d)
        finally:
            for f in os.listdir(d):
                os.remove(os.path.join(d, f))
            os.rmdir(d)
        values = {}
        for m in spec.metrics(workload, trace=True):
            v = spec.reader(m["name"])(ctx)
            if v is not None:
                values[m["name"]] = {"value": v, "unit": m["unit"]}
        sl = ctx["slice"]
        extra = {"busy_s": sl.busy_s, "window_s": sl.window_s}
        breakdown = {"device_ops": [[n, s] for n, s in sl.ops],
                     "idle_gaps": [[n, s] for n, s in sl.gaps]}
        window = ctx
    else:
        window = mix.window(seconds)
        values = {m["name"]: {"value": setup_s if m["name"] == "setup_s" else window[m["name"]],
                              "unit": m["unit"]}
                  for m in spec.metrics(workload, trace=False)}
        extra, breakdown = {}, None
        print("window: " + json.dumps(window["about"]), file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    mix.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = mix.check()
    result = {
        "correct": verdict(numbers, limits),
        "attempted": window["attempted"],
        "failed": window["failed"],
        "metrics": values,
        "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                   "count": cell["chips"], "memory_peak_bytes": peak, **extra},
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return result, mix.parts
