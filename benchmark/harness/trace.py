"""What a traced slice of a run holds, from the chrome trace that
``repnerv_tpu_torch/utils/profiling.py::trace`` writes.

``GROUPS`` and the device-time reduction are ``chip_smoke.py``'s
``PROFILE_GROUPS`` / ``profile_groups`` (kernel-name fragments, the first
match wins), and the busy time is its ``timeline``'s union of every kernel,
copy and set on the card; here they read the trace file's events rather than
``key_averages()``, so that the window, the busy time and the gaps come from
one record.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

# kernel-name fragments -> the group a device kernel counts under
GROUPS = [
    ("K2", ("int8", "s8policy")),
    ("K1/K3", ("stage_wgmma", "tensor_core::kernel", "cuda_core::kernel")),
    ("K4", ("epilogue_bwd",)),
    ("K5", ("blur_tiles",)),
    ("library conv", ("conv", "cudnn", "xmma", "implicit_gemm", "wgrad", "dgrad", "sm90_",
                      "cutlass")),
    ("Adam", ("adam", "multi_tensor")),
]
OTHER = "other"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10  # entries of each breakdown list
NAME_CHARS = 120  # of a kernel's or an op's name in a breakdown


def group_of(name: str) -> str:
    low = name.lower()
    for group, frags in GROUPS:
        if any(f in low for f in frags):
            return group
    return OTHER


def merged(intervals: List[Tuple[float, float]]) -> List[List[float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


@dataclass
class Slice:
    """The device's work inside one span of the benchmark's own code."""

    window_s: float  # the span's length on the host's clock
    busy_s: float  # the union of the device's kernels, copies and sets
    group_s: Dict[str, float]  # device seconds by kernel group
    ops: List[Tuple[str, float]]  # device seconds by kernel name, largest first
    gaps: List[Tuple[str, float]] = field(default_factory=list)  # longest idle gaps, by host op


def read_slice(path: str, span: str) -> Slice:
    """The device events whose launch lies inside the benchmark's span
    ``span`` (a ``record_function`` name), matched to their launch by
    correlation id: the card's clock, mapped onto the host's, can be off by
    milliseconds (ROADMAP C24), the launch's own time is not."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and e.get("name") == span
             and e.get("cat") == "user_annotation"]
    if not spans:
        raise RuntimeError(f"the trace {path} holds no span {span!r}")
    t0 = float(spans[0]["ts"])
    t1 = t0 + float(spans[0]["dur"])
    launched = {}
    host_ops = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        if cat in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launched[corr] = float(e["ts"])
        if cat in ("cpu_op", "user_annotation", "python_function", "cuda_runtime"):
            host_ops.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", "")))
    intervals, by_name, groups = [], {}, {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        # an event without a launch on record goes by its own time
        at = launched.get(e.get("args", {}).get("correlation"), float(e["ts"]))
        if not t0 <= at <= t1:
            continue
        a, d = float(e["ts"]), float(e["dur"])
        intervals.append((a, a + d))
        name = e.get("name", "")
        by_name[name] = by_name.get(name, 0.0) + d
        if e.get("cat") == "kernel":
            g = group_of(name)
            groups[g] = groups.get(g, 0.0) + d
    busy = merged(intervals)
    ops = sorted(((n[:NAME_CHARS], us / 1e6) for n, us in by_name.items()),
                 key=lambda x: -x[1])[:TOP]
    return Slice(window_s=(t1 - t0) / 1e6, busy_s=sum(b - a for a, b in busy) / 1e6,
                 group_s={g: us / 1e6 for g, us in groups.items()}, ops=ops,
                 gaps=idle_gaps(busy, host_ops, t0, t1))


def idle_gaps(busy: List[List[float]], host_ops, t0: float, t1: float) -> List[Tuple[str, float]]:
    """The longest stretches of the span in which the card ran nothing,
    each named by the innermost host op running at its middle."""
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for a, b in gaps[:TOP]:
        mid = (a + b) / 2
        # the innermost host op under the gap's middle, the span itself
        # aside; else the host was in Python after the op that ended last
        around = [(e - s, n) for s, e, n in host_ops if s <= mid <= e and (s, e) != (t0, t1)]
        if around:
            name = min(around)[1]
        else:
            before = [(e, n) for s, e, n in host_ops if e <= mid]
            name = f"host after {max(before)[1]}" if before else "host before the first op"
        out.append((name[:NAME_CHARS], (b - a) / 1e6))
    return out
