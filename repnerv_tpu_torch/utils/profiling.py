"""Tracing, step timing and device memory (port of
``repnerv_tpu/utils/profiling.py``).

* ``trace`` captures a ``torch.profiler`` trace of a block of work into a
  directory (TensorBoard's layout: one ``*.pt.trace.json`` a session and
  process), the counterpart of the JAX package's ``jax.profiler`` trace.  On
  a CUDA device it fails when the kernel wrappers launched and the written
  trace holds no kernel: an empty trace is never handed back as one;
* ``StepTimer`` times blocks of work on a device: on a CUDA device with two
  CUDA events around the block and a wait for the second (the work is
  asynchronous), on the CPU with the host clock;
* ``device_memory_stats`` reads a CUDA device's bytes in use, peak and
  total from ``torch.cuda.memory_stats``.

All three raise when asked for a CUDA device and there is none.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import socket
import time
from typing import Counter, Dict, List, Optional

import torch

from ..kernels import launches


def _cuda_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{device} was asked for, but no CUDA device is available")
    return device


def kernel_events(path: str) -> Counter[str]:
    """The device-kernel events of a written trace, counted by kernel name."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return collections.Counter(e.get("name", "") for e in events
                               if e.get("ph") == "X" and e.get("cat") == "kernel")


@dataclasses.dataclass
class Trace:
    """What one ``trace`` block recorded.  ``path`` (the trace file),
    ``launched`` and ``kernels`` are set when the block ends."""

    profiler: object  # the torch.profiler.profile: key_averages() after the block
    path: str = ""
    launched: int = 0  # K1-K5 launches the wrappers counted in the block
    kernels: Optional[Counter[str]] = None  # kernel events of the file (CUDA only)


def _worker_name() -> str:
    name = f"{socket.gethostname()}_{os.getpid()}"
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        name += f"_rank{torch.distributed.get_rank()}"  # ranks never share a file
    return name


# On the H100 machines the GPU records' timestamps, mapped onto the host's
# clock, are now and then off by up to tens of milliseconds, most of all for
# the first records after the profiler turns CUDA activity on, and the
# profiler drops every GPU record that then lies outside its window
# (ROADMAP C24; ``tools/probe_profiler.py``).  So ``trace`` runs
# ``PRIME_KERNELS`` fills on a CUDA device before its window opens (they
# take the first records' error), and keeps the window open
# ``WINDOW_PAD_S`` of host time before and after the traced block.
PRIME_KERNELS = 64
WINDOW_PAD_S = 0.25


def _prime(device: torch.device) -> None:
    prime = torch.zeros(1, device=device)
    for _ in range(PRIME_KERNELS):
        prime.fill_(1.0)
    torch.cuda.synchronize(device)


@contextlib.contextmanager
def trace(log_dir: str, device="cuda"):
    """Capture a ``torch.profiler`` trace of the block into ``log_dir``;
    yields a ``Trace``.

    On a CUDA device it records the host's ops and the card's kernels and
    copies: it first runs ``PRIME_KERNELS`` fills in the profiler's warm-up
    phase, then opens the window ``WINDOW_PAD_S`` before the block, waits
    for the card after it and closes the window ``WINDOW_PAD_S`` later, and
    raises when the kernel wrappers launched in the block and the written
    trace holds no kernel event.  On the CPU it records the host's ops."""
    from torch.profiler import ProfilerActivity, profile, schedule, tensorboard_trace_handler

    device = _cuda_device(device)
    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    handler = tensorboard_trace_handler(log_dir, worker_name=_worker_name())
    written = []

    def ready(prof):
        before = set(os.listdir(log_dir)) if os.path.isdir(log_dir) else set()
        handler(prof)
        written.extend(sorted(set(os.listdir(log_dir)) - before))

    # step 0 is the warm-up (activities on, nothing kept), step 1 the window
    prof = profile(activities=activities, schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                   on_trace_ready=ready)
    prof.record_steps = False  # no ProfilerStep span around the block
    with prof:
        if cuda:
            _prime(device)
        prof.step()  # the window opens
        if cuda:
            time.sleep(WINDOW_PAD_S)
        before = launches.snapshot()
        rec = Trace(profiler=prof)
        yield rec
        if cuda:
            torch.cuda.synchronize(device)
            time.sleep(WINDOW_PAD_S)
    rec.path = os.path.join(log_dir, written[-1])
    rec.launched = launches.total(launches.since(before))
    if cuda:
        rec.kernels = kernel_events(rec.path)
        if rec.launched and not rec.kernels:
            raise RuntimeError(
                f"torch.profiler wrote {rec.path} with no kernel event, though the kernel "
                f"wrappers launched {rec.launched} kernels in the traced block")


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
