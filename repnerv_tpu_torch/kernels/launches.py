"""The kernels' launch counts as one record.

Each kernel wrapper adds one to a module-level count where it launches its
kernel: ``decode.LAUNCHES``, ``ROUTE_LAUNCHES`` and ``INT8_OUT_LAUNCHES`` (K1),
``decode_int8.LAUNCHES`` and ``ROUTE_LAUNCHES`` (K2),
``train_tail.FWD_LAUNCHES``, ``FWD_ROUTE_LAUNCHES``, ``FWD_STRIDE_LAUNCHES``
(K3), ``BWD_LAUNCHES`` and ``BWD_STRIDE_LAUNCHES`` (K4), ``ssim_blur.LAUNCHES``
and ``ROUTE_LAUNCHES`` (K5), ``reparam_fuse.FWD_LAUNCHES`` and
``VJP_LAUNCHES`` (ERB's branch fusion and its VJP).
A CUDA graph's capture calls the wrappers without running a kernel, and its
replay runs the kernels without calling a wrapper: the code that captures a
graph takes the capture's counts back (``add(counts, -1)``) and adds them at
every replay (``add(counts)``), so the counts stay the kernels that ran.
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

from . import decode, decode_int8, reparam_fuse, ssim_blur, train_tail

_COUNTERS = (
    (decode, "LAUNCHES"),
    (decode, "ROUTE_LAUNCHES"),
    (decode, "INT8_OUT_LAUNCHES"),
    (decode_int8, "LAUNCHES"),
    (decode_int8, "ROUTE_LAUNCHES"),
    (train_tail, "FWD_LAUNCHES"),
    (train_tail, "FWD_ROUTE_LAUNCHES"),
    (train_tail, "FWD_STRIDE_LAUNCHES"),
    (train_tail, "BWD_LAUNCHES"),
    (train_tail, "BWD_STRIDE_LAUNCHES"),
    (ssim_blur, "LAUNCHES"),
    (ssim_blur, "ROUTE_LAUNCHES"),
    (reparam_fuse, "FWD_LAUNCHES"),
    (reparam_fuse, "VJP_LAUNCHES"),
)

# counts of launches that another count holds already
_PARTS = {(decode.__name__, "INT8_OUT_LAUNCHES")}

Counts = Dict[Tuple[str, str], Union[int, Dict[str, int]]]


def snapshot() -> Counts:
    """Every count as it stands: an int, or a copy of a by-route dict."""
    out: Counts = {}
    for mod, name in _COUNTERS:
        v = getattr(mod, name)
        out[mod.__name__, name] = dict(v) if isinstance(v, dict) else v
    return out


def since(before: Counts) -> Counts:
    """The launches counted after ``before`` was taken."""
    now = snapshot()
    return {k: ({r: n - before[k][r] for r, n in v.items()} if isinstance(v, dict)
                else v - before[k])
            for k, v in now.items()}


def total(counts: Counts) -> int:
    """The kernel launches in ``counts`` (the by-route dicts and ``_PARTS``
    split the same launches again)."""
    return sum(v for k, v in counts.items() if isinstance(v, int) and k not in _PARTS)


def add(counts: Counts, times: int = 1) -> None:
    """Add ``times`` x ``counts`` to the wrappers' counts."""
    for mod, name in _COUNTERS:
        delta = counts[mod.__name__, name]
        v = getattr(mod, name)
        if isinstance(v, dict):
            for r, n in delta.items():
                v[r] += times * n
        else:
            setattr(mod, name, v + times * delta)
