"""When does a ``torch.profiler`` trace hold no kernel, though the kernel
wrappers launched?  (ROADMAP C24.)

    python -m repnerv_tpu_torch.tools.probe_profiler \\
        [--plan conditions|state|prime|fix|pad] [--sessions N] --out FILE.json

One process on one card runs many short profiler sessions, each over the
same work: 5 calls of K5's single-map blur on one 720p map and 5 of an
ATen multiply in place (one kernel each), the ``kernel_device_ms`` calls of
``chip_smoke.py`` at their smallest.  Each session is exported as a chrome
trace and read back: K5's kernel events and the ATen kernel's, the CUDA
runtime's launch calls, the launch calls whose kernel is missing, and
where the kernels lie in the recorded window (``Iteration Start`` ..
``Record Window End``); a kernel's start minus the start of the runtime
call that launched it (the same ``correlation``) says how the card's
records, mapped onto the host's clock, sit against the host's own.  With
``KINETO_LOG_LEVEL=1`` in the environment the profiler logs, per session,
how many records it dropped as outside its window ("Out-of-range").

Plans (``PLANS``), sessions of each condition in turns or in blocks as
each plan's docstring says:

* ``conditions``: CUDA activity alone, back to back, CPU and CUDA, the two
  in turns, a padded window, the package's ``trace``, after idle gaps,
  after a world of one over NCCL and over gloo;
* ``state``: fresh sessions, then after ``BUSY_S`` of untraced work, after
  gaps, after the worlds of one, with waits and long sessions;
* ``prime``: kernels (fills) run in the profiler's warm-up phase, before
  the window opens, against none, inside the window, or in a throwaway
  session just before;
* ``fix``: the package's ``trace`` against plain and primed sessions;
* ``pad``: primed sessions with host sleeps inside the window around the
  calls.

Prints one line a condition (sessions, empty, partial, kernels seen, the
offsets) and writes every session to ``--out``.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import tempfile
import time

import torch
import torch.distributed as dist

from ..kernels import launches
from ..kernels import ssim_blur as sb
from ..parallel import sharding
from ..utils.profiling import PRIME_KERNELS, trace

CALLS = 5
PAD_S = 0.05
GAP_S = 5.0
BUSY_S = 60.0
LONG_PAD_S = 0.5
LONG_CALLS = 100
PRIME = 16
ROUNDS = 4
FIX_ROUNDS = 6


def _work():
    img = torch.rand(1, 720, 1280, device="cuda")
    buf = torch.rand(1 << 20, device="cuda")
    win = sb.window_tuple(11, 1.5)

    def call():
        sb.blur_valid(img, win)
        buf.mul_(1.0)

    return call


def _kind(name: str) -> str:
    """K5's kernel, a priming kernel (a fill) or the calls' ATen kernel."""
    return "k5" if "blur_tiles" in name else "prime" if "Fill" in name else "aten"


def _read(path: str) -> dict:
    """Kernel and launch events of one chrome trace, and their place in
    the recorded window (microseconds)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"]
    runtime = {e.get("args", {}).get("correlation"): e for e in events
               if e.get("ph") == "X" and e.get("cat", "").startswith("cuda_")
               and "aunch" in e.get("name", "")}  # the runtime's and the CUDA API's launches
    marks = {e.get("name"): float(e["ts"]) for e in events if e.get("ph") == "i"}
    start = marks.get("Iteration Start: PyTorch Profiler")
    end = marks.get("Record Window End")
    offsets = [float(k["ts"]) - float(runtime[c]["ts"]) for k in kernels
               if (c := k.get("args", {}).get("correlation")) in runtime]
    t0 = start if start is not None else 0.0
    seen = {k.get("args", {}).get("correlation") for k in kernels}
    out = {"kernel_list": [[k.get("args", {}).get("correlation"),
                            _kind(k["name"]),
                            round(float(k["ts"]) - t0, 3), round(float(k["dur"]), 3)]
                           for k in kernels],
           # the launch calls whose kernel is not in the trace: [correlation,
           # start in the window, the call's duration]
           "lost": [[c, round(float(e["ts"]) - t0, 3), round(float(e["dur"]), 3)]
                    for c, e in runtime.items() if c not in seen],
           "k5": sum(_kind(k["name"]) == "k5" for k in kernels),
           "aten": sum(_kind(k["name"]) == "aten" for k in kernels),
           "prime": sum(_kind(k["name"]) == "prime" for k in kernels),
           "launch_calls": len(runtime),
           "cats": dict(collections.Counter(e.get("cat") for e in events if e.get("ph") == "X")),
           "launch_to_kernel_us": [min(offsets), max(offsets)] if offsets else None}
    if kernels and start is not None and end is not None:
        out["first_kernel_after_start_us"] = min(float(k["ts"]) for k in kernels) - start
        out["window_end_after_last_kernel_us"] = end - max(
            float(k["ts"]) + float(k["dur"]) for k in kernels)
        out["window_us"] = end - start
    return out


class Probe:
    def __init__(self, tmp: str):
        self.tmp = tmp
        self.call = _work()
        self.tiny = torch.zeros(1, device="cuda")
        self.call()  # builds the kernels
        torch.cuda.synchronize()
        self.sessions = []
        self.t_start = self.last_stop = time.perf_counter()

    def busy(self, seconds: float) -> None:
        """Untraced calls, a wait after each, for ``seconds``."""
        t_end = time.perf_counter() + seconds
        while time.perf_counter() < t_end:
            self.call()
            torch.cuda.synchronize()

    def session(self, cond: str, cpu: bool, warm: bool = True, pad: float = 0.0,
                gap: float = 0.0, calls: int = CALLS, pad_after: float = 0.0) -> dict:
        from torch.profiler import ProfilerActivity, profile

        if gap:
            time.sleep(gap)
        if warm:
            self.call()
            torch.cuda.synchronize()
        acts = ([ProfilerActivity.CPU] if cpu else []) + [ProfilerActivity.CUDA]
        rec = {"cond": cond, "cpu": cpu, "pad_s": pad, "calls": calls,
               "since_last_stop_s": time.perf_counter() - self.last_stop,
               "since_start_s": time.perf_counter() - self.t_start}
        before = launches.snapshot()
        with profile(activities=acts) as prof:
            if pad:
                time.sleep(pad)
            for _ in range(calls):
                self.call()
            torch.cuda.synchronize()
            if pad or pad_after:
                time.sleep(pad or pad_after)
        self.last_stop = time.perf_counter()
        rec["launched"] = launches.total(launches.since(before))
        rec["key_averages_kernels"] = sum(
            1 for e in prof.key_averages() if getattr(e, "self_device_time_total", 0.0))
        path = os.path.join(self.tmp, f"s{len(self.sessions)}.json")
        prof.export_chrome_trace(path)
        rec.update(_read(path))
        os.remove(path)
        self.sessions.append(rec)
        return rec

    def primed(self, cond: str, cpu: bool, n_prime: int, in_window: bool = False,
               throwaway: bool = False, pad: float = 0.0) -> dict:
        """A session whose profiler first runs ``n_prime`` fill kernels: in a
        warm-up phase (``schedule(warmup=1)``: the activities are on, the
        window not yet open), inside the window before the calls
        (``in_window``), or in a session of their own just before
        (``throwaway``)."""
        from torch.profiler import ProfilerActivity, profile, schedule

        self.call()
        torch.cuda.synchronize()
        acts = ([ProfilerActivity.CPU] if cpu else []) + [ProfilerActivity.CUDA]
        if throwaway:
            with profile(activities=acts):
                for _ in range(n_prime):
                    self.tiny.fill_(1.0)
                torch.cuda.synchronize()
        rec = {"cond": cond, "cpu": cpu, "pad_s": 0.0, "calls": CALLS, "n_prime": n_prime,
               "since_last_stop_s": time.perf_counter() - self.last_stop,
               "since_start_s": time.perf_counter() - self.t_start}
        before = launches.snapshot()
        warm = not (in_window or throwaway)
        sched = schedule(wait=0, warmup=1, active=1, repeat=1) if warm else None
        with profile(activities=acts, schedule=sched) as prof:
            if not throwaway:
                for _ in range(n_prime):
                    self.tiny.fill_(1.0)
                torch.cuda.synchronize()
            if warm:
                prof.step()  # the window opens
            time.sleep(pad)
            for _ in range(CALLS):
                self.call()
            torch.cuda.synchronize()
            time.sleep(pad)
        self.last_stop = time.perf_counter()
        rec["launched"] = launches.total(launches.since(before))
        path = os.path.join(self.tmp, f"s{len(self.sessions)}.json")
        prof.export_chrome_trace(path)
        rec.update(_read(path))
        os.remove(path)
        self.sessions.append(rec)
        return rec

    def package_trace(self, cond: str) -> dict:
        self.call()
        torch.cuda.synchronize()
        rec = {"cond": cond, "cpu": True, "pad_s": 0.0, "calls": CALLS,
               "since_last_stop_s": time.perf_counter() - self.last_stop,
               "since_start_s": time.perf_counter() - self.t_start}
        d = os.path.join(self.tmp, f"t{len(self.sessions)}")
        try:
            with trace(d, "cuda") as t:
                for _ in range(CALLS):
                    self.call()
            rec.update(launched=t.launched, refused=False)
            rec.update(_read(t.path))
        except RuntimeError as e:
            rec.update(launched=CALLS, refused=True, error=str(e), k5=0, aten=0)
        self.last_stop = time.perf_counter()
        self.sessions.append(rec)
        return rec


def summary(sessions: list) -> dict:
    by = collections.defaultdict(list)
    for s in sessions:
        by[s["cond"]].append(s)
    out = {}
    for cond, rows in by.items():
        offs = [s["launch_to_kernel_us"] for s in rows if s.get("launch_to_kernel_us")]
        out[cond] = {
            "sessions": len(rows),
            "empty": sum(1 for s in rows if s["launched"] and not (s["k5"] or s["aten"])),
            "partial": sum(1 for s in rows if 0 < s["k5"] + s["aten"] < 2 * s["calls"]),
            "prime_seen": sum(s.get("prime", 0) for s in rows),
            "kernels_seen": sum(s["k5"] + s["aten"] for s in rows),
            "kernels_launched": sum(2 * s["calls"] for s in rows),
            "refused": sum(1 for s in rows if s.get("refused")),
            "empty_indices": [i for i, s in enumerate(rows)
                              if s["launched"] and not (s["k5"] or s["aten"])],
            "launch_calls_in_empty": [s.get("launch_calls") for s in rows
                                      if s["launched"] and not (s["k5"] or s["aten"])],
            "launch_to_kernel_us_min": min((o[0] for o in offs), default=None),
            "launch_to_kernel_us_median": (statistics.median(o[0] for o in offs)
                                           if offs else None),
            "launch_to_kernel_us_max": max((o[1] for o in offs), default=None),
        }
    return out


def _worlds_of_one() -> None:
    """A world of one over NCCL, then one over gloo, each with an
    all-reduce, each closed again."""
    mesh = sharding.make_mesh((1,), ("data",), "cuda")
    dist.all_reduce(torch.ones(1 << 10, device="cuda"))
    torch.cuda.synchronize()
    sharding.close_mesh(mesh)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    dist.all_reduce(torch.ones(4))
    dist.destroy_process_group()


def plan_conditions(p: Probe, n: int) -> None:
    """The conditions of the module docstring, in its order."""
    for _ in range(n):
        p.session("cuda", cpu=False)
    for _ in range(n):
        p.session("cuda-b2b", cpu=False, warm=False)
    for _ in range(n):
        p.session("cpu+cuda", cpu=True)
    for i in range(n):
        p.session("alt", cpu=bool(i % 2))
    for _ in range(n):
        p.session("cuda-pad", cpu=False, pad=PAD_S)
    for _ in range(n):
        p.package_trace("trace")
    for _ in range(8):
        p.session("gap", cpu=False, gap=GAP_S)
        p.session("gap-pad", cpu=False, gap=GAP_S, pad=PAD_S)
    _worlds_of_one()
    for _ in range(n):
        p.session("after-dist-cuda", cpu=False)
    for _ in range(n):
        p.session("after-dist-cpu+cuda", cpu=True)


def plan_state(p: Probe, n: int) -> None:
    """What puts the profiler into the state that loses kernels, and what
    a session in that state keeps: sessions after ``BUSY_S`` of untraced
    work, after idle gaps, after the worlds of one; then in that state a
    wait of ``LONG_PAD_S`` before the profiler stops, a window opened
    ``LONG_PAD_S`` before the calls, ``LONG_CALLS`` calls, and the
    package's trace."""
    for _ in range(n):
        p.session("fresh-cuda", cpu=False)
    for _ in range(n):
        p.session("fresh-cpu+cuda", cpu=True)
    p.busy(BUSY_S)
    for _ in range(n):
        p.session("after-busy-cuda", cpu=False)
    for _ in range(6):
        p.session("gap", cpu=False, gap=GAP_S)
    for _ in range(n):
        p.session("after-gap-cuda", cpu=False)
    for _ in range(n):
        p.session("after-gap-cpu+cuda", cpu=True)
    _worlds_of_one()
    for _ in range(n):
        p.session("after-dist-cuda", cpu=False)
    for _ in range(10):
        p.session("wait-before-stop", cpu=True, pad_after=LONG_PAD_S)
    for _ in range(10):
        p.session("window-open-early", cpu=True, pad=LONG_PAD_S)
    for _ in range(10):
        p.session("long", cpu=True, calls=LONG_CALLS)
    for _ in range(n):
        p.package_trace("trace")


def plan_prime(p: Probe, n: int) -> None:
    """Whether kernels run before the window opens take the loss: in
    ``ROUNDS`` rounds, each after ``BUSY_S / ROUNDS`` of untraced work (the
    state that loses the first kernels of a session comes and goes), ``n``
    turns of: a plain session (CUDA alone, then CPU and CUDA), sessions
    primed with ``PRIME`` fill kernels in a warm-up phase, a warm-up phase
    without kernels, the fills inside the window, a throwaway session of
    fills just before, and the package's trace."""
    for r in range(ROUNDS):
        p.busy(BUSY_S / ROUNDS)
        for _ in range(n):
            p.session("plain-cuda", cpu=False)
            p.session("plain-cpu+cuda", cpu=True)
            p.primed(f"warmup-{PRIME}-fills", cpu=True, n_prime=PRIME)
            p.primed("warmup-no-kernel", cpu=True, n_prime=0)
            p.primed(f"window-{PRIME}-fills-first", cpu=True, n_prime=PRIME, in_window=True)
            p.primed(f"throwaway-{PRIME}-fills", cpu=True, n_prime=PRIME, throwaway=True)
            p.package_trace("trace")


def plan_fix(p: Probe, n: int) -> None:
    """The package's trace (``PRIME_KERNELS`` fills in its warm-up phase)
    against plain sessions and 16 fills, in turns, in ``FIX_ROUNDS`` rounds
    each after ``BUSY_S / FIX_ROUNDS * 2`` of untraced work."""
    for r in range(FIX_ROUNDS):
        p.busy(BUSY_S / FIX_ROUNDS * 2)
        for _ in range(n):
            p.session("plain-cpu+cuda", cpu=True)
            p.primed(f"warmup-{PRIME}-fills", cpu=True, n_prime=PRIME)
            p.primed(f"warmup-{PRIME_KERNELS}-fills", cpu=True, n_prime=PRIME_KERNELS)
            p.package_trace("trace")


def plan_pad(p: Probe, n: int) -> None:
    """Sessions primed with ``PRIME_KERNELS`` fills in the warm-up phase,
    and the same with host sleeps of ``PAD_S`` and ``LONG_PAD_S`` inside the
    window before the calls and after the wait, in turns with plain
    sessions, in ``FIX_ROUNDS`` rounds each after ``BUSY_S / FIX_ROUNDS * 2``
    of untraced work."""
    for r in range(FIX_ROUNDS):
        p.busy(BUSY_S / FIX_ROUNDS * 2)
        for _ in range(n):
            p.session("plain-cpu+cuda", cpu=True)
            p.primed(f"warmup-{PRIME_KERNELS}-fills", cpu=True, n_prime=PRIME_KERNELS)
            p.primed(f"warmup-{PRIME_KERNELS}-fills-pad-{PAD_S}", cpu=True,
                     n_prime=PRIME_KERNELS, pad=PAD_S)
            p.primed(f"warmup-{PRIME_KERNELS}-fills-pad-{LONG_PAD_S}", cpu=True,
                     n_prime=PRIME_KERNELS, pad=LONG_PAD_S)


PLANS = {"conditions": plan_conditions, "state": plan_state, "prime": plan_prime,
         "fix": plan_fix, "pad": plan_pad}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="")
    ap.add_argument("--plan", choices=sorted(PLANS), default="conditions")
    ap.add_argument("--sessions", type=int, default=60, help="sessions a condition")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_profiler: needs a CUDA device")
    with tempfile.TemporaryDirectory() as tmp:
        p = Probe(tmp)
        PLANS[a.plan](p, a.sessions)
    res = {"device": torch.cuda.get_device_name(0), "torch": torch.__version__,
           "cuda": torch.version.cuda, "plan": a.plan, "calls": CALLS,
           "summary": summary(p.sessions), "sessions": p.sessions}
    for cond, s in res["summary"].items():
        print(f"[c24] {cond}: {s['empty']} empty of {s['sessions']} sessions "
              f"(at {s['empty_indices'][:12]}; launch calls in them "
              f"{s['launch_calls_in_empty'][:12]}), {s['partial']} partial, "
              f"{s['kernels_seen']} of {s['kernels_launched']} kernels seen ({s['prime_seen']} "
              f"fills), {s['refused']} "
              f"refused; kernel start - launch call start {s['launch_to_kernel_us_min']} .. "
              f"median {s['launch_to_kernel_us_median']} .. {s['launch_to_kernel_us_max']} us",
              flush=True)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
