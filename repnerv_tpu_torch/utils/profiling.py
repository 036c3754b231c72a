"""Tracing, program spans, step timing and device memory (port of
``repnerv_tpu/utils/profiling.py``).

* ``trace`` captures a ``torch.profiler`` trace of a block of work into a
  directory (TensorBoard's layout: one ``*.pt.trace.json`` a session and
  process), the counterpart of the JAX package's ``jax.profiler`` trace.  On
  a CUDA device it fails when the kernel wrappers launched and the written
  trace holds no kernel: an empty trace is never handed back as one.  When
  the block ends it reads the file once and sums it by program span
  (``Trace.spans``, ``Trace.idle``); ``last_trace()`` hands back the last
  block's ``Trace``;
* ``span(name)`` marks a stretch of the program as one of its layers.
  Inside a ``trace`` block it is a ``record_function`` range.  While
  ``CapturedGraph.capture`` (``train/loop.py``) captures a CUDA graph through
  ``capture_graph``, it records the graph's kernel, memset and memcpy node
  counts at its entry and exit (``csrc/graph_nodes.cu``): a range of the
  graph's ops, which the summary charges to the span at every replay of the
  graph (a replay runs no Python).  Otherwise it does nothing;
* ``name_node(fragment)``, called by a kernel wrapper before it launches,
  marks the op that the capture adds next as a kernel whose name holds
  ``fragment``.  The summary matches a replay's ops of that name to those
  nodes, in order, and the other ops to the other nodes, so that a kernel
  on a stream of its own, which a replay may start before ops captured
  ahead of it, is still charged to its own span;
* ``StepTimer`` times blocks of work on a device: on a CUDA device with two
  CUDA events around the block and a wait for the second (the work is
  asynchronous), on the CPU with the host clock;
* ``device_memory_stats`` reads a CUDA device's bytes in use, peak and
  total from ``torch.cuda.memory_stats``.

``trace``, ``StepTimer`` and ``device_memory_stats`` raise when asked for a
CUDA device and there is none.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import ctypes
import dataclasses
import itertools
import json
import os
import socket
import time
import weakref
from typing import Counter, Dict, List, Optional, Tuple

import torch
from torch.profiler import record_function


def _cuda_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{device} was asked for, but no CUDA device is available")
    return device


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")  # a trace's device events
REPLAY = "graph.replay:"  # a replay span's name: this and its ``Labels.id``


def _read_events(path: str) -> list:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _kernel_counts(events: list) -> Counter[str]:
    return collections.Counter(e.get("name", "") for e in events
                               if e.get("ph") == "X" and e.get("cat") == "kernel")


def kernel_events(path: str) -> Counter[str]:
    """The device-kernel events of a written trace, counted by kernel name."""
    return _kernel_counts(_read_events(path))


# ---------------------------------------------------------------------------
# Spans and the labels of a captured graph
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GraphLabels:
    """One captured CUDA graph's ops (kernel, memset and memcpy nodes, in
    the order the capture added them) and the span ranges over them."""

    nodes: int = -1  # at the end of the capture; -1: not counted
    # (span path below the capture, first op, end op)
    ranges: List[Tuple[str, int, int]] = dataclasses.field(default_factory=list)
    stack: List[str] = dataclasses.field(default_factory=list)  # spans open in the capture
    # kernel-name fragment -> the ops of kernels so named (``name_node``)
    named: Dict[str, List[int]] = dataclasses.field(default_factory=dict)

    def op_paths(self) -> List[str]:
        """The innermost span path of each op ("" outside every span)."""
        out = [""] * max(self.nodes, 0)
        for path, a, b in sorted(self.ranges, key=lambda r: r[0].count("/")):
            out[a:b] = [path] * (min(b, len(out)) - a)  # inner spans paint over outer ones
        return out

    def in_op_order(self, names: List[str]) -> Optional[List[int]]:
        """The positions, in a replay's start order, of the ops of the graph
        in its own order, from the replayed ops' ``names``: the ops whose
        name holds a ``named`` fragment to those nodes in turn, the rest to
        the rest.  None where the counts differ."""
        if not self.named:
            return list(range(len(names)))
        out: List[Optional[int]] = [None] * len(names)
        rest = list(range(len(names)))
        for fragment, nodes in self.named.items():
            mine = [i for i in rest if fragment in names[i]]
            if len(mine) != len(nodes) or any(not 0 <= n < len(out) for n in nodes):
                return None
            for n, i in zip(nodes, mine):
                out[n] = i
            rest = [i for i in rest if fragment not in names[i]]
        free = [n for n, i in enumerate(out) if i is None]
        if len(free) != len(rest):
            return None
        for n, i in zip(free, rest):
            out[n] = i
        return out


class Labels:
    """The label table of one ``CapturedGraph.capture``: a ``GraphLabels``
    for each CUDA graph it captured, in order.  Its graphs replay inside
    ``span(labels.span)`` (``graph.replay:<id>``), by which the summary of a
    trace finds the table."""

    def __init__(self, kind: str):
        self.id = f"{kind}.{next(_IDS)}"
        self.span = REPLAY + self.id
        self.graphs: List[GraphLabels] = []
        _TABLES[self.id] = self


_IDS = itertools.count(1)
_TABLES: "weakref.WeakValueDictionary[str, Labels]" = weakref.WeakValueDictionary()
_TRACES = 0  # trace blocks open
_CAPTURE: Optional[Labels] = None  # the table that the captures in progress fill
_GRAPH: Optional[GraphLabels] = None  # the labelled graph being captured
_ON = False  # a trace block is open or a labelled graph is being captured
_OFF = contextlib.nullcontext()


def _switch() -> None:
    global _ON
    _ON = bool(_TRACES) or _GRAPH is not None


def capture_nodes() -> int:
    """The kernel, memset and memcpy nodes of the CUDA graph that the current
    stream is capturing into; -1 when it captures none or CUDA fails."""
    from ..kernels.build import load_library

    n = load_library().repnerv_capture_nodes(
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    return n if n >= 0 else -1


class _Span:
    __slots__ = ("name", "rf", "graph", "first")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = None
        if _TRACES:
            self.rf = record_function(self.name)
            self.rf.__enter__()
        self.graph = g = _GRAPH
        if g is not None:
            g.stack.append(self.name)
            self.first = capture_nodes()
        return self

    def __exit__(self, *exc):
        g = self.graph
        if g is not None:
            g.ranges.append(("/".join(g.stack), self.first, capture_nodes()))
            g.stack.pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def name_node(fragment: str) -> None:
    """Mark the op that the current stream adds next to the labelled graph
    being captured as a kernel whose name holds ``fragment`` (a kernel
    wrapper calls it before it launches); nothing outside such a capture."""
    g = _GRAPH
    if g is not None:
        g.named.setdefault(fragment, []).append(capture_nodes())


def span(name: str):
    """A context manager that marks the block as the program span ``name``:
    a ``record_function`` range inside a ``trace`` block, a labelled range
    of ops in a CUDA graph that ``capture_graph`` captures, and nothing at
    all otherwise (one module-level check)."""
    if not _ON:
        return _OFF
    return _Span(name)


@contextlib.contextmanager
def labelled(kind: str):
    """Yield a new ``Labels`` (``kind`` begins its id) that the CUDA graphs
    captured through ``capture_graph`` in the block fill, one entry each."""
    global _CAPTURE
    labels = Labels(kind)
    _CAPTURE = labels
    try:
        yield labels
    finally:
        _CAPTURE = None


@contextlib.contextmanager
def capture_graph(graph, stream, **kwargs):
    """``torch.cuda.graph(graph, stream=stream, **kwargs)``.  Inside
    ``labelled`` the spans in the block record their ranges of the graph's
    ops, and the graph's op count is taken as the capture ends."""
    global _GRAPH
    with torch.cuda.graph(graph, stream=stream, **kwargs):
        labels = _CAPTURE
        if labels is None:
            yield
            return
        g = GraphLabels()
        labels.graphs.append(g)
        _GRAPH = g
        _switch()
        try:
            yield
            n = capture_nodes()
            # a count that failed leaves the graph uncounted: never attributed
            counted = all(a >= 0 and b >= 0 for _, a, b in g.ranges) and all(
                k >= 0 for nodes in g.named.values() for k in nodes)
            g.nodes = n if counted else -1
        finally:
            _GRAPH = None
            _switch()


# ---------------------------------------------------------------------------
# A trace's summary by span
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SpanTime:
    """One span path's share of a trace.  A path below a replay span
    (``graph.replay:<id>/<path in the capture>``) is a labelled range of the
    graph: its count is the replays that ran it, and it has no host time."""

    count: int = 0  # times the span ran
    host_s: float = 0.0  # host seconds inside it
    self_s: float = 0.0  # of those, outside its child spans
    device_s: float = 0.0  # device seconds of the ops charged to it (not to a child)
    ops: int = 0  # device ops (kernels, copies, sets) charged to it


def _thread_segments(items, stats) -> list:
    """``items``: (start, end, name) of one thread's spans.  Adds each span's
    count and host seconds to ``stats`` by path; returns the thread's
    segments (start, end, path, instance) in time order, each a stretch in
    which ``path`` was the innermost span open (``instance`` tells two runs
    of one path apart)."""
    segs = []
    stack = []  # [end, path, instance, children's host time, start]
    t = 0.0

    def close(t):
        end, path, inst, kids, start = stack.pop()
        if end > t:
            segs.append((t, end, path, inst))
        st = stats[path]
        st.host_s += (end - start) / 1e6
        st.self_s += (end - start - kids) / 1e6
        if stack:
            stack[-1][3] += end - start
        return max(t, end)

    for inst, (a, b, name) in enumerate(sorted(items, key=lambda s: (s[0], -s[1]))):
        while stack and stack[-1][0] <= a:
            t = close(t)
        if stack:
            b = min(b, stack[-1][0])
            if a > t:
                segs.append((t, a, stack[-1][1], stack[-1][2]))
        path = f"{stack[-1][1]}/{name}" if stack else name
        stats[path].count += 1
        stack.append([b, path, inst, 0.0, a])
        t = a
    while stack:
        t = close(t)
    return segs


class _Timelines:
    """Which span each thread was in, at a time on the host's clock.  A
    thread with no span open there (autograd's device thread, which runs a
    backward while the thread that called ``backward()`` waits inside its
    span) reads the main thread's: the one that opened the most spans."""

    def __init__(self, by_thread: dict, stats):
        self.segs = {th: _thread_segments(items, stats) for th, items in by_thread.items()}
        self.starts = {th: [s[0] for s in segs] for th, segs in self.segs.items()}
        self.main = max(by_thread, key=lambda th: len(by_thread[th])) if by_thread else None

    def _find(self, th, x):
        i = bisect.bisect_right(self.starts.get(th, ()), x) - 1
        if i >= 0 and self.segs[th][i][1] > x:
            return self.segs[th][i]
        return None

    def thread_at(self, th, x):
        """The thread whose spans hold the host time ``x`` of thread ``th``."""
        if self._find(th, x) is None and self.main is not None:
            return self.main
        return th

    def at(self, th, x):
        """(thread, path, instance) of the innermost span open at ``x``."""
        th = self.thread_at(th, x)
        seg = self._find(th, x)
        return (th, seg[2], seg[3]) if seg else (th, "", None)

    def split(self, th, x0, x1, into: Dict[str, float]) -> None:
        """Add the host stretch [x0, x1] of thread ``th``, in seconds, to
        ``into`` by the innermost span open ("" where none is)."""
        segs = self.segs.get(th, [])
        i = max(bisect.bisect_right(self.starts.get(th, ()), x0) - 1, 0)
        covered = 0.0
        for a, b, path, _ in segs[i:]:
            if a >= x1:
                break
            d = min(b, x1) - max(a, x0)
            if d > 0:
                into[path] = into.get(path, 0.0) + d / 1e6
                covered += d
        if x1 - x0 > covered:
            into[""] = into.get("", 0.0) + (x1 - x0 - covered) / 1e6


def summarize(events: list, tables=None):
    """A chrome trace's events by program span: returns (spans: path ->
    ``SpanTime``, idle: path -> seconds, the ids of the unattributed
    tables).  A path joins the names of the spans open around it with "/";
    "" is no span.  ``tables``: label id -> ``Labels`` (default: every live
    table).

    * Host spans are ``user_annotation`` ranges, nested by thread.
    * An eagerly launched op is charged to the innermost span open on the
      launching thread at its runtime launch call, found by correlation id.
    * The ops of one ``cudaGraphLaunch`` inside a ``graph.replay:<id>`` span,
      in start order (the kernels of a ``name_node`` fragment and the rest
      each in their own): the k-th goes to the innermost label range of the
      table's graph (the n-th launch in the span replays its n-th graph)
      that covers k, below the replay span's path.  A replay whose launches
      or op counts differ from the table's is not guessed at: its ops go to
      the replay span, and the table's id is listed as unattributed.
    * An idle gap of the card before op B is charged on the host's clock
      through B's launch: inside a replay to B's own path; otherwise the
      gap's length, laid back from the end of B's launch call (the
      ``cudaGraphLaunch`` for a replay's first op), is split over the spans
      the launching thread was in then.  B's device time, mapped onto the
      host's clock, can be off by milliseconds and is never read for it."""
    tables = _TABLES if tables is None else tables
    spans: Dict[str, SpanTime] = collections.defaultdict(SpanTime)
    by_thread = collections.defaultdict(list)
    launches = {}  # correlation -> (start, end, thread, name)
    ops = []  # [start, dur, correlation, name]
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat")
        ts, dur = float(e["ts"]), float(e["dur"])
        if cat == "user_annotation":
            by_thread[e.get("pid"), e.get("tid")].append((ts, ts + dur, e.get("name", "")))
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (ts, ts + dur, (e.get("pid"), e.get("tid")), e.get("name", ""))
        elif cat in DEVICE_CATS:
            ops.append((ts, dur, e.get("args", {}).get("correlation"), e.get("name", "")))
    lines = _Timelines(by_thread, spans)

    by_corr = collections.defaultdict(list)
    for i, op in enumerate(ops):
        by_corr[op[2]].append(i)
    path_of = [""] * len(ops)
    inner = [False] * len(ops)  # a replayed op after the replay's first
    replays = collections.defaultdict(list)  # (thread, replay span instance) -> [correlation]
    for corr, idx in by_corr.items():
        idx.sort(key=lambda i: ops[i][0])
        launch = launches.get(corr)
        if launch is None:
            continue  # no launch on record: no span
        th, path, inst = lines.at(launch[2], launch[0])
        graph = "GraphLaunch" in launch[3]
        if graph and path.rsplit("/", 1)[-1].startswith(REPLAY):
            replays[th, inst].append(corr)
        for k, i in enumerate(idx):
            path_of[i], inner[i] = path, graph and k > 0
    unattributed = set()
    for (th, _), corrs in replays.items():
        corrs.sort(key=lambda c: launches[c][0])
        replay = path_of[by_corr[corrs[0]][0]]
        tid = replay.rsplit("/", 1)[-1][len(REPLAY):]
        table = tables.get(tid)
        graphs = table.graphs if table is not None else []
        order = [g.in_op_order([ops[i][3] for i in by_corr[c]]) if g.nodes == len(by_corr[c])
                 else None for c, g in zip(corrs, graphs)]
        if len(graphs) != len(corrs) or any(o is None for o in order):
            unattributed.add(tid)
            continue
        for c, g, o in zip(corrs, graphs, order):
            for k, label in zip(o, g.op_paths()):
                if label:
                    path_of[by_corr[c][k]] = f"{replay}/{label}"
            for label, _, _ in g.ranges:
                spans[f"{replay}/{label}"].count += 1
    for i, (_, dur, _, _) in enumerate(ops):
        st = spans[path_of[i]]
        st.device_s += dur / 1e6
        st.ops += 1

    idle: Dict[str, float] = {}
    busy_end = None
    for i in sorted(range(len(ops)), key=lambda i: ops[i][0]):
        ts, dur, corr, _ = ops[i]
        if busy_end is not None and ts > busy_end:
            gap = ts - busy_end
            launch = launches.get(corr)
            if inner[i] or launch is None:
                idle[path_of[i]] = idle.get(path_of[i], 0.0) + gap / 1e6
            else:
                end = launch[1]
                lines.split(lines.thread_at(launch[2], launch[0]), end - gap, end, idle)
        busy_end = ts + dur if busy_end is None else max(busy_end, ts + dur)
    return dict(spans), idle, sorted(unattributed)


def summary_line(rec: "Trace", top: int = 5) -> str:
    """The ``top`` span paths of a trace by device ms, by idle ms of the card
    and by host ms outside child spans, on one line."""

    def best(pairs):
        pairs = sorted(((v, k) for k, v in pairs if v > 0), reverse=True)[:top]
        return ", ".join(f"{k or '(no span)'} {v * 1e3:.3f}" for v, k in pairs) or "none"

    return (f"by device ms: {best((k, s.device_s) for k, s in rec.spans.items())}; "
            f"by idle ms: {best(rec.idle.items())}; "
            f"by host ms: {best((k, s.self_s) for k, s in rec.spans.items())}")


# ---------------------------------------------------------------------------
# trace
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Trace:
    """What one ``trace`` block recorded.  The rest of the fields are set
    when the block ends: ``path`` (the trace file), ``launched``, ``kernels``
    and the summary by span (``summarize``)."""

    profiler: object  # the torch.profiler.profile: key_averages() after the block
    path: str = ""
    launched: int = 0  # K1-K5 launches the wrappers counted in the block
    kernels: Optional[Counter[str]] = None  # kernel events of the file (CUDA only)
    spans: Dict[str, SpanTime] = dataclasses.field(default_factory=dict)  # by span path
    idle: Dict[str, float] = dataclasses.field(default_factory=dict)  # the card's idle s by path
    unattributed: List[str] = dataclasses.field(default_factory=list)  # label ids not matched


_LAST: Optional[Trace] = None


def last_trace() -> Optional[Trace]:
    """The ``Trace`` of the last ``trace`` block that ended, summary and
    all; None before the first."""
    return _LAST


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
    yields a ``Trace``.  Spans (``span``) are ``record_function`` ranges in
    the block.

    On a CUDA device it records the host's ops and the card's kernels and
    copies: it first runs ``PRIME_KERNELS`` fills in the profiler's warm-up
    phase, then opens the window ``WINDOW_PAD_S`` before the block, waits
    for the card after it and closes the window ``WINDOW_PAD_S`` later, and
    raises when the kernel wrappers launched in the block and the written
    trace holds no kernel event.  On the CPU it records the host's ops.
    The written file is read once, for ``kernels`` and the summary."""
    global _TRACES, _LAST
    from torch.profiler import ProfilerActivity, profile, schedule, tensorboard_trace_handler

    from ..kernels import launches

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
        _TRACES += 1
        _switch()
        try:
            yield rec
        finally:
            _TRACES -= 1
            _switch()
        if cuda:
            torch.cuda.synchronize(device)
            time.sleep(WINDOW_PAD_S)
    rec.path = os.path.join(log_dir, written[-1])
    rec.launched = launches.total(launches.since(before))
    events = _read_events(rec.path)
    rec.spans, rec.idle, rec.unattributed = summarize(events)
    _LAST = rec
    if cuda:
        rec.kernels = _kernel_counts(events)
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
