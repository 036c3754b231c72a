"""Step timing and device memory (port of ``repnerv_tpu/utils/profiling.py``;
its ``trace`` is the JAX profiler's: the port traces with ``torch.profiler``).

* ``StepTimer`` times blocks of work on a device: on a CUDA device with two
  CUDA events around the block and a wait for the second (the work is
  asynchronous), on the CPU with the host clock;
* ``device_memory_stats`` reads a CUDA device's bytes in use, peak and
  total from ``torch.cuda.memory_stats``.

Both raise when asked for a CUDA device and there is none.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import torch


def _cuda_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{device} was asked for, but no CUDA device is available")
    return device


class StepTimer:
    """Step times with completion: every ``measure()`` block appends its time.

    Usage::

        timer = StepTimer("cuda")
        with timer.measure():
            state, aux = step(...)
        print(timer.best_ms, timer.mean_ms)
    """

    def __init__(self, device="cuda"):
        self.device = _cuda_device(device)
        self.times: List[float] = []  # seconds

    @contextlib.contextmanager
    def measure(self):
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            yield
            self.times.append(time.perf_counter() - t0)
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(torch.cuda.current_stream(self.device))
        yield
        end.record(torch.cuda.current_stream(self.device))
        end.synchronize()
        self.times.append(start.elapsed_time(end) / 1e3)

    @property
    def best_ms(self) -> float:
        return min(self.times) * 1e3 if self.times else float("nan")

    @property
    def mean_ms(self) -> float:
        return sum(self.times) / len(self.times) * 1e3 if self.times else float("nan")


def device_memory_stats(device="cuda") -> Dict[str, float]:
    """Bytes in use, their peak and the device's total for a CUDA device;
    an empty dict for the CPU (no device memory)."""
    device = _cuda_device(device)
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": float(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": float(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": float(torch.cuda.get_device_properties(device).total_memory),
    }
